"""The port's ``ShardedDatabase`` (``vector_db_torch/parallel/sharded.py``)
against the reference's: the cases of ``tests/test_sharded.py`` from
``TestShardedDatabase`` on (the multi-process example waits for its port),
the sharded cases of ``test_round3_fixes.py`` and ``test_round4_fixes.py``,
and the checkpoints both ways.  The reference runs on its 8-device CPU
mesh, the port on 8 (or 4) logical CPU shards, with the same calls on the
same seeded numpy inputs.

Bars: slot layouts (``_h_ids``, ``_h_valid``, ``_fill``) equal after the
same adds and removes; exact searches return equal ids and distances within
rtol 1e-5 (atol 1e-4: the f32 cancellation of a distance near 0); the raw tier's ``train_pq`` codebooks within 1e-4 and its
permutation and codes equal; the approximate searches reach at least the
reference's recall against an exact oracle (less 0.01 where the reference's
codebooks come from its own random draws); a checkpoint of either package
loads into the other on 4 and 8 shards, in the dense and the
``payload_sharded`` format, with ids, codes, scales and the packed levels
equal per id and the same search ids.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from vector_db_tpu.parallel import sharded as ref_sh  # noqa: E402
from vector_db_tpu.storage import checkpoint as ref_ckpt  # noqa: E402
from vector_db_torch.index import hnsw_pq  # noqa: E402
from vector_db_torch.parallel import sharded as sh  # noqa: E402
from vector_db_torch.storage import checkpoint as ckpt  # noqa: E402

K = 10
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8, "conftest must provide 8 devices"
    return {8: (ref_sh.make_mesh(8), sh.make_mesh(devices=[CPU] * 8)),
            4: (ref_sh.make_mesh(4), sh.make_mesh(devices=[CPU] * 4))}


def _pair(meshes, n_shards=8, **kw):
    jm, tm = meshes[n_shards]
    return ref_sh.ShardedDatabase(jm, **kw), sh.ShardedDatabase(tm, **kw)


def _rows(n, dim, seed, offset=0.0, spectral=False):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, dim))
    if spectral:
        x = x * (np.arange(dim) + 1.0) ** -0.5
    return (x + offset).astype(np.float32)


def _gt(vecs, q, k=K, metric="l2"):
    v, qq = vecs.astype(np.float64), q.astype(np.float64)
    if metric == "cosine":
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
        return np.argsort(-(qq / np.linalg.norm(qq, axis=1,
                                                keepdims=True)) @ v.T,
                          1)[:, :k]
    return np.argsort(((qq[:, None] - v[None]) ** 2).sum(-1), 1)[:, :k]


def _rec(ext, gt):
    ext = np.asarray(ext)
    return float(np.mean([len(set(ext[i].tolist()) & set(gt[i].tolist()))
                          / gt.shape[1] for i in range(len(gt))]))


def _same_layout(j, t):
    np.testing.assert_array_equal(t._h_ids, j._h_ids)
    np.testing.assert_array_equal(t._h_valid, j._h_valid)
    np.testing.assert_array_equal(t._fill, j._fill)
    assert t._free == j._free


def _same_search(t_out, j_out, rtol=1e-5):
    np.testing.assert_array_equal(np.asarray(t_out[0]), np.asarray(j_out[0]))
    jd = np.asarray(j_out[1])
    fin = np.isfinite(jd)
    np.testing.assert_allclose(np.asarray(t_out[1])[fin], jd[fin],
                               rtol=rtol, atol=1e-4)


# -------------------------------------------------- construction, search
class TestShardedDatabase:
    def test_exact_search(self, meshes):
        vecs = _rows(512, 32, 42)
        j, t = _pair(meshes, vectors=vecs, ids=np.arange(512, dtype=np.int32),
                     valid=np.ones(512, bool))
        _same_layout(j, t)
        ext, _ = t.search(vecs[:8], 1)
        np.testing.assert_array_equal(ext[:, 0], np.arange(8))
        q = _rows(16, 32, 1)
        _same_search(t.search(q, K), j.search(q, K))

    def test_flagship_with_imported_codes(self, meshes):
        from vector_db_tpu.ops import adc as ref_adc
        from vector_db_tpu.ops.kmeans import subspace_kmeans_fit

        vecs = _rows(512, 32, 42)
        cb = np.asarray(subspace_kmeans_fit(jax.random.PRNGKey(0),
                                            jnp.asarray(vecs), 4, k=16,
                                            iters=5))
        codes = np.asarray(ref_adc.pq_encode(jnp.asarray(vecs),
                                             jnp.asarray(cb)))
        j, t = _pair(meshes, vectors=vecs, ids=np.arange(512, dtype=np.int32),
                     valid=np.ones(512, bool), codes=codes, codebooks=cb)
        np.testing.assert_array_equal(t._h_codes, j._h_codes)
        ext, _ = t.search_flagship(vecs[:8], 5, refine=32)
        np.testing.assert_array_equal(ext[:, 0], np.arange(8))
        q = _rows(16, 32, 2)
        _same_search(t.search_flagship(q, 5, refine=64),
                     j.search_flagship(q, 5, refine=64))

    def test_pads_uneven_corpus(self, meshes):
        vecs = _rows(100, 16, 3)
        j, t = _pair(meshes, vectors=vecs, ids=np.arange(100, dtype=np.int32),
                     valid=np.ones(100, bool))
        _same_layout(j, t)
        ext, _ = t.search(vecs[:4], 3)
        np.testing.assert_array_equal(ext[:, 0], np.arange(4))
        assert (ext >= -1).all() and (ext < 100).all()


class TestShardedCrudBuild:
    def test_train_pq_matches_reference(self, meshes):
        vecs = _rows(300, 32, 7)  # 300 % 8 != 0
        j, t = _pair(meshes, dim=32, capacity=512, num_subspaces=4)
        assert t.add_batch(np.arange(300), vecs) == j.add_batch(
            np.arange(300), vecs)
        _same_layout(j, t)
        j.train_pq(num_centroids=16, iters=5)
        t.train_pq(num_centroids=16, iters=5)
        np.testing.assert_array_equal(t.perm.numpy(), np.asarray(j.perm))
        np.testing.assert_allclose(t.codebooks.numpy(),
                                   np.asarray(j.codebooks), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(t._h_codes, j._h_codes)
        ext, _ = t.search_flagship(vecs[:8], 5, refine=64)
        np.testing.assert_array_equal(ext[:, 0], np.arange(8))
        _same_search(t.search_flagship(vecs[:32], 5, refine=64),
                     j.search_flagship(vecs[:32], 5, refine=64))
        ext2, _ = t.search(vecs[:8], 1)
        np.testing.assert_array_equal(ext2[:, 0], np.arange(8))

    def test_train_pq_cosine_matches_reference(self, meshes):
        vecs = _rows(256, 32, 11) * np.random.default_rng(12).uniform(
            0.1, 10.0, (256, 1)).astype(np.float32)
        j, t = _pair(meshes, dim=32, capacity=512, num_subspaces=4,
                     metric="cosine")
        for db in (j, t):
            db.add_batch(np.arange(256), vecs)
        _same_search(t.search(2.5 * vecs[7:8], 3), j.search(2.5 * vecs[7:8], 3))
        assert t.search(2.5 * vecs[7:8], 3)[0][0, 0] == 7
        for db in (j, t):
            db.train_pq(num_centroids=16, iters=6)
        np.testing.assert_allclose(t.codebooks.numpy(),
                                   np.asarray(j.codebooks), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(t._h_codes, j._h_codes)
        assert t.search_flagship(3.0 * vecs[7:8], 3, refine=32)[0][0, 0] == 7
        t.fit_pca(8)
        assert t.search_pca(0.5 * vecs[7:8], 3, select_r=32)[0][0, 0] == 7

    def test_incremental_adds_after_train(self, meshes):
        vecs = _rows(200, 32, 8)
        j, t = _pair(meshes, dim=32, capacity=512, num_subspaces=4)
        for db in (j, t):
            db.add_batch(np.arange(100), vecs[:100])
            db.train_pq(num_centroids=16, iters=4)
            db.add_batch(np.arange(100, 200), vecs[100:])
        _same_layout(j, t)
        np.testing.assert_array_equal(t._h_codes, j._h_codes)
        ext, _ = t.search_flagship(vecs[150:154], 3, refine=32)
        np.testing.assert_array_equal(ext[:, 0], np.arange(150, 154))

    def test_deletes_and_slot_reuse(self, meshes):
        r = np.random.default_rng(9)
        vecs = r.standard_normal((100, 16)).astype(np.float32)
        more = r.standard_normal((30, 16)).astype(np.float32)
        j, t = _pair(meshes, dim=16, capacity=128)
        for db in (j, t):
            db.add_batch(np.arange(100), vecs)
            for i in range(0, 100, 3):
                assert db.remove(i)
        _same_layout(j, t)
        ext, _ = t.search(vecs[:6], 2)
        for row in range(6):
            if row % 3 == 0:
                assert row not in ext[row]
            else:
                assert ext[row, 0] == row
        for db in (j, t):
            assert len(db.add_batch(np.arange(1000, 1030), more)) == 30
        _same_layout(j, t)
        assert (t._fill <= t.per_shard).all()
        _same_search(t.search(more[:3], 1), j.search(more[:3], 1))

    def test_duplicate_ids_rejected(self, meshes):
        vecs = _rows(10, 16, 10)
        j, t = _pair(meshes, dim=16, capacity=64)
        assert t.add_batch([1, 1, 2, -5], vecs[:4]) == j.add_batch(
            [1, 1, 2, -5], vecs[:4]) == [1, 2]
        assert t.size() == 2


class TestWaterFilling:
    @pytest.mark.parametrize("prior", [None, [30, 5, 0, 60]])
    def test_four_shards(self, meshes, prior):
        """test_round4_fixes.py's case: balanced, and an uneven prior load
        fills the lowest shards first, never over-filling."""
        j, t = _pair(meshes, 4, dim=16, capacity=4 * 64)
        vecs = _rows(100, 16, 0)
        for db in (j, t):
            if prior:
                db._fill[:] = prior
            db.add_batch(np.arange(1000, 1100), vecs)
        _same_layout(j, t)
        load = t._fill - np.asarray([len(f) for f in t._free])
        if prior:
            assert load.tolist() == [45, 45, 45, 60]
        else:
            assert load.max() - load.min() <= 1

    def test_bulk_ingest_balanced_and_bounded(self, meshes):
        vecs = _rows(100_000, 16, 23)
        j, t = _pair(meshes, dim=16, capacity=100_000)
        for db in (j, t):
            assert len(db.add_batch(np.arange(100_000), vecs)) == 100_000
        _same_layout(j, t)
        j, t = _pair(meshes, dim=16, capacity=1024)
        for db in (j, t):
            assert len(db.add_batch(np.arange(1200), vecs[:1200])) == 1024
        _same_layout(j, t)
        assert t.capacity == 1024 and t.size() == 1024


class TestShardedPca:
    def test_search_pca_and_mutation(self, meshes):
        vecs = _rows(256, 32, 7)
        j, t = _pair(meshes, dim=32, capacity=512, num_subspaces=4)
        for db in (j, t):
            db.add_batch(np.arange(256), vecs)
            db.fit_pca(8)
        np.testing.assert_allclose(t.pca_basis.numpy(),
                                   np.asarray(j.pca_basis), atol=1e-6)
        ext, _ = t.search_pca(vecs[:8], 3, select_r=32)
        assert (ext[:, 0] == np.arange(8)).all()
        q = _rows(16, 32, 70)
        gt = _gt(vecs, q, 3)
        assert _rec(t.search_pca(q, 3, select_r=32)[0], gt) >= _rec(
            j.search_pca(q, 3, select_r=32)[0], gt)
        assert t.remove(0)  # mutations reach the cached proxy
        assert 0 not in t.search_pca(vecs[:1], 3, select_r=32)[0][0]


class TestShardedPersistence:
    def test_save_load_roundtrip_preserves_search(self, meshes, tmp_path):
        vecs = _rows(400, 32, 21)
        _, t = _pair(meshes, dim=32, capacity=512, num_subspaces=4)
        t.add_batch(np.arange(400), vecs)
        t.train_pq(num_centroids=16, iters=5)
        t.fit_pca(8)
        for i in range(0, 40, 3):
            t.remove(i)
        q = _rows(16, 32, 22)
        before = (t.search(q, 5), t.search_flagship(q, 5, refine=64),
                  t.search_pca(q, 5, select_r=64))
        t.save(str(tmp_path / "sdb"))
        t2 = sh.ShardedDatabase.load(meshes[8][1], str(tmp_path / "sdb"))
        assert t2.size() == t.size()
        after = (t2.search(q, 5), t2.search_flagship(q, 5, refine=64),
                 t2.search_pca(q, 5, select_r=64))
        for b, a in zip(before, after):
            _same_search(a, b)
        assert t2.remove(100)
        assert len(t2.add_batch([9000], vecs[:1])) == 1

    def test_load_onto_different_mesh_size(self, meshes, tmp_path):
        vecs = _rows(300, 16, 22)
        _, t = _pair(meshes, dim=16, capacity=512)
        t.add_batch(np.arange(300), vecs)
        t.save(str(tmp_path / "s"))
        t2 = sh.ShardedDatabase.load(meshes[4][1], str(tmp_path / "s"))
        assert t2.n_shards == 4 and t2.size() == 300
        np.testing.assert_array_equal(t2.search(vecs[:8], 1)[0][:, 0],
                                      np.arange(8))

    def test_missing_checkpoint_raises(self, meshes, tmp_path):
        with pytest.raises(FileNotFoundError):
            sh.ShardedDatabase.load(meshes[8][1], str(tmp_path / "nope"))


# ------------------------------------------------------- compressed tier
class TestShardedCompressedTier:
    def test_int8_scan_matches_reference(self, meshes):
        vecs = _rows(2048, 64, 31)
        j, t = _pair(meshes, dim=64, capacity=2048, raw_store=False)
        for db in (j, t):
            db.add_batch(np.arange(2048), vecs)
        np.testing.assert_array_equal(t._h_packed, j._h_packed)
        np.testing.assert_array_equal(t._h_scales, j._h_scales)
        q = _rows(64, 64, 32)
        _same_search(t.search(q, K), j.search(q, K), rtol=1e-4)
        assert _rec(t.search(q, K)[0], _gt(vecs, q)) >= 0.97

    def test_flagship_int8_refine(self, meshes):
        vecs = _rows(2048, 64, 32, spectral=True)
        _, t = _pair(meshes, dim=64, capacity=2112, num_subspaces=16,
                     raw_store=False)
        t.add_batch(np.arange(2048), vecs)
        t.train_pq(num_centroids=64, iters=8)
        q = _rows(64, 64, 33, spectral=True)
        assert _rec(t.search_flagship(q, 10, refine=128)[0],
                    _gt(vecs, q)) >= 0.9
        more = _rows(8, 64, 34, spectral=True) + 2.0
        t.add_batch(np.arange(5000, 5008), more)
        ext, _ = t.search_flagship(more, 1, refine=128)
        np.testing.assert_array_equal(ext[:, 0], np.arange(5000, 5008))

    def test_compressed_save_load(self, meshes, tmp_path):
        vecs = _rows(1024, 32, 33)
        _, t = _pair(meshes, dim=32, capacity=1024, num_subspaces=8,
                     raw_store=False)
        t.add_batch(np.arange(1024), vecs)
        t.train_pq(num_centroids=32, iters=5)
        q = _rows(16, 32, 34)
        before = t.search(q, 5), t.search_flagship(q, 5, refine=64)
        t.save(str(tmp_path / "c8"))
        t2 = sh.ShardedDatabase.load(meshes[8][1], str(tmp_path / "c8"))
        assert not t2.raw
        _same_search(t2.search(q, 5), before[0])
        _same_search(t2.search_flagship(q, 5, refine=64), before[1])

    def test_pca_unfitted_guarded(self, meshes):
        _, t = _pair(meshes, dim=32, capacity=256, raw_store=False)
        t.add_batch(np.arange(64), _rows(64, 32, 0))
        with pytest.raises(ValueError, match="fit_pca"):
            t.search_pca(np.zeros((1, 32), np.float32), 1)

    @pytest.mark.parametrize("raw,epilogue,metric", [
        (False, "per_row", "l2"), (False, "per_row", "cosine"),
        (True, "per_row", "l2"), (True, "global", "l2"),
        (True, "global", "cosine")])
    def test_fused_scan_recall(self, meshes, raw, epilogue, metric):
        vecs = _rows(2048, 64, 34, offset=2.0 if metric == "l2" else 3.0)
        q = _rows(32, 64, 35, offset=2.0 if metric == "l2" else 3.0)
        j, t = _pair(meshes, dim=64, capacity=2048, metric=metric,
                     raw_store=raw, int8_epilogue=epilogue)
        for db in (j, t):
            db.add_batch(np.arange(2048), vecs)
        gt = _gt(vecs, q, metric=metric)
        ext, d = t.search_fused(q, K)
        assert _rec(ext, gt) >= _rec(j.search_fused(q, K)[0], gt)
        assert (d[:, :-1] <= d[:, 1:] + 1e-5).all()
        t.remove(0)  # the conditioning follows the mutation
        assert t.search_fused(vecs[:1], 1)[0][0, 0] != 0

    def test_search_auto_routes_to_fused(self, meshes):
        assert sh.ShardedDatabase.fused_threshold == \
            hnsw_pq.AUTO_INT8_MIN_ROWS
        vecs = _rows(1024, 32, 36)
        j, t = _pair(meshes, dim=32, capacity=1024, raw_store=False)
        calls = []
        for db in (j, t):
            db.add_batch(np.arange(1024), vecs)
            db.fused_threshold = 1  # the crossover at test scale
            orig = db._search_fused_impl
            db._search_fused_impl = (
                lambda q, k, orig=orig, **kw: (calls.append(1),
                                               orig(q, k))[1])
        q = _rows(8, 32, 37)
        _same_search(t.search(q, 1), j.search(q, 1), rtol=1e-4)
        assert len(calls) == 2
        assert (t.search(vecs[:4], 1)[0][:, 0] == np.arange(4)).all()

    def test_int8_epilogue_and_residual_validated(self, meshes):
        with pytest.raises(ValueError, match="int8_epilogue"):
            sh.ShardedDatabase(meshes[8][1], dim=32, capacity=256,
                               int8_epilogue="bogus")
        with pytest.raises(ValueError, match="refine_residual"):
            sh.ShardedDatabase(meshes[8][1], dim=32, capacity=256,
                               refine_residual=True)

    def test_fused_width_1920_rows_a_shard(self, meshes):
        """test_round4_fixes.py: capacity 15,360 on 8 shards is 1,920 rows
        a shard, which the kernel's 2,048 width would round past."""
        _, t = _pair(meshes, dim=64, capacity=15360, raw_store=False)
        assert t.per_shard == 1920
        vecs = _rows(4096, 64, 11, offset=1.0)
        t.add_batch(np.arange(4096), vecs)
        q = vecs[:8] + 0.01 * _rows(8, 64, 12)
        assert np.mean(t.search_fused(q, 5)[0][:, 0] == np.arange(8)) >= 0.9


class TestShardedResidualRefine:
    def test_fused_residual_beats_single_level(self, meshes):
        vecs = _rows(2048, 64, 41)
        q = vecs[:48] + 0.02 * _rows(48, 64, 42)
        gt = _gt(vecs, q)
        recs = {}
        for res in (False, True):
            _, t = _pair(meshes, dim=64, capacity=2048, raw_store=False,
                         refine_residual=res)
            t.add_batch(np.arange(2048), vecs)
            recs[res] = _rec(t.search_fused(q, K)[0], gt)
        assert recs[True] >= recs[False] and recs[True] >= 0.99, recs

    def test_flagship_residual(self, meshes):
        vecs = _rows(2048, 64, 42, spectral=True)
        _, t = _pair(meshes, dim=64, capacity=2112, num_subspaces=16,
                     raw_store=False, refine_residual=True)
        t.add_batch(np.arange(2048), vecs)
        t.train_pq(num_centroids=64, iters=8)
        q = _rows(48, 64, 43, spectral=True)
        assert _rec(t.search_flagship(q, K, refine=256)[0],
                    _gt(vecs, q)) >= 0.9

    def test_residual_levels_match_reference(self, meshes):
        vecs = _rows(1024, 32, 43)
        j, t = _pair(meshes, dim=32, capacity=1024, raw_store=False,
                     refine_residual=True)
        for db in (j, t):
            db.add_batch(np.arange(1024), vecs)
        for name in ("_h_packed", "_h_scales", "_h_resid", "_h_rscales"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
        q = _rows(32, 32, 44)
        _same_search(t.search(q, K), j.search(q, K), rtol=1e-4)
        assert _rec(t.search(q, K)[0], _gt(vecs, q)) == 1.0


class TestShardedCompressedPca:
    @pytest.mark.parametrize("residual", [False, True])
    def test_compressed_pca_recall(self, meshes, residual):
        vecs = _rows(2048, 64, 51, spectral=True)
        j, t = _pair(meshes, dim=64, capacity=2048, raw_store=False,
                     refine_residual=residual)
        for db in (j, t):
            db.add_batch(np.arange(2048), vecs)
            db.fit_pca(p=16)
        q = _rows(48, 64, 52, spectral=True)
        gt = _gt(vecs, q)
        ext, d = t.search_pca(q, K, select_r=256)
        assert _rec(ext, gt) >= max(0.9, _rec(
            j.search_pca(q, K, select_r=256)[0], gt))
        assert (d[:, :-1] <= d[:, 1:] + 1e-5).all()

    def test_proxy_tracks_mutations(self, meshes):
        vecs = _rows(1024, 32, 52)
        _, t = _pair(meshes, dim=32, capacity=1152, raw_store=False)
        t.add_batch(np.arange(1024), vecs)
        t.fit_pca(p=16)
        t.search_pca(vecs[:4], 1)
        newv = _rows(4, 32, 53) + 3.0
        t.add_batch(np.arange(9000, 9004), newv)
        assert t.search_pca(newv, 1, select_r=128)[0][:, 0].tolist() == [
            9000, 9001, 9002, 9003]


class TestShardedConcurrency:
    def test_concurrent_search_and_add(self, meshes):
        import concurrent.futures

        n = 512
        vecs = _rows(n + 64, 32, 61)
        _, t = _pair(meshes, dim=32, capacity=n + 128, raw_store=False,
                     refine_residual=True)
        t.add_batch(np.arange(n), vecs[:n])
        t.search(vecs[:4], 3)

        def searcher(_):
            ext, d = t.search(vecs[:4], 3)
            return (ext[:, 0] == np.arange(4)).all() and bool(
                (d[:, :-1] <= d[:, 1:] + 1e-5).all())

        def mutator(i):
            return t.add_batch(np.asarray([n + i]),
                               vecs[n + i:n + i + 1]) == [n + i]

        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
            futs = [ex.submit(searcher if i % 2 else mutator, i)
                    for i in range(32)]
            assert all(f.result() for f in futs)
        added = n + np.arange(0, 32, 2)
        assert (t.search(vecs[added], 1)[0][:, 0] == added).all()


# ------------------------------------------------------- device payload
class TestDevicePayload:
    def test_no_host_payload_arrays(self, meshes):
        for raw in (True, False):
            _, t = _pair(meshes, dim=32, capacity=1024, raw_store=raw,
                         host_mirror=False)
            assert not hasattr(t, "_h_packed") and not hasattr(t, "_h_vec")
            assert ("vectors" if raw else "packed") in t._pieces

    @pytest.mark.parametrize("raw", [True, False])
    def test_crud_and_search_parity(self, meshes, raw):
        vecs = _rows(1024, 32, 71, offset=1.0)
        q = vecs[:16] + 0.01 * _rows(16, 32, 72)
        out = {}
        for hm in (True, False):
            j, t = _pair(meshes, dim=32, capacity=1024, raw_store=raw,
                         host_mirror=hm)
            for db in (j, t):
                db.add_batch(np.arange(1024), vecs)
            _same_layout(j, t)
            out[hm] = t.search(q, K)
            _same_search(out[hm], j.search(q, K), rtol=1e-4)
            t.remove(3)
            assert t.search(vecs[3:4], 1)[0][0, 0] != 3
            t.add_batch([5000], vecs[:1] * 2.0)  # reuses the freed slot
            assert t.search(vecs[:1] * 2.0, 1)[0][0, 0] == 5000
        _same_search(out[False], out[True])

    def test_in_place_writes_reach_the_caches(self, meshes):
        """A fused search, an add into a shard that already has rows (its
        device piece written in place, so the piece keeps its identity),
        then a fused search must find the new row; the same for the PCA
        proxy.  Caches keyed on the pieces' identity would serve the old
        conditioning and miss it."""
        for raw in (True, False):
            _, t = _pair(meshes, dim=32, capacity=1024, raw_store=raw,
                         host_mirror=False)
            vecs = _rows(512, 32, 73, offset=0.5)
            t.add_batch(np.arange(512), vecs)
            t.fit_pca(8)
            t.search_fused(vecs[:2], 1)
            t.search_pca(vecs[:2], 1)
            piece = t._pieces["vectors" if raw else "packed"][0]
            far = np.full((1, 32), 4.0, np.float32)
            t.add_batch([7777], far)
            assert t._pieces["vectors" if raw else "packed"][0] is piece
            assert t.search_fused(far, 1)[0][0, 0] == 7777
            assert t.search_pca(far, 1)[0][0, 0] == 7777

    def test_stream_ingest(self, meshes):
        vecs = _rows(2048, 32, 73, offset=0.5)
        _, t = _pair(meshes, dim=32, capacity=2048, raw_store=False,
                     num_subspaces=8, host_mirror=False)
        total = t.bulk_load_stream(
            ((np.arange(s, s + 256), vecs[s:s + 256])
             for s in range(0, 2048, 256)), num_centroids=16)
        assert total == 2048 and t.codebooks is not None
        assert t._h_codes[:2048].any()
        assert _rec(t.search(vecs[:16], K)[0], _gt(vecs, vecs[:16])) >= 0.95
        ext, _ = t.search_flagship(vecs[:8], 1, refine=64)
        np.testing.assert_array_equal(ext[:, 0], np.arange(8))
        with pytest.raises(ValueError):
            t.bulk_load_stream([(np.asarray([1]), vecs[:1])])

    def test_save_load_roundtrip(self, meshes, tmp_path):
        vecs = _rows(1024, 32, 74, offset=1.0)
        _, t = _pair(meshes, dim=32, capacity=1024, raw_store=False,
                     refine_residual=True, num_subspaces=8,
                     host_mirror=False)
        t.bulk_load_stream([(np.arange(1024), vecs)], num_centroids=16)
        t.fit_pca(p=8)
        q = vecs[:16]
        before = t.search(q, K)
        path = str(tmp_path / "devckpt")
        t.save(path)
        for hm in (False, True):
            t2 = sh.ShardedDatabase.load(meshes[8][1], path, host_mirror=hm)
            _same_search(t2.search(q, K), before, rtol=0)
            assert (t2.search_pca(q[:8], 5)[0][:, 0] == np.arange(8)).all()


# ------------------------------------------------- checkpoints both ways
def _per_id(db, ids, port):
    """(codes, scales, packed words, residual words) of ``ids`` in db."""
    slots = np.asarray([db._slot_of[int(i)] for i in ids], np.int64)
    out = [db._h_codes[slots]]
    if db.raw:
        return out + [db._rows_host(slots)]
    out.append(db._h_scales[slots])
    for name in db._payload_fields:
        if db.host_mirror:
            out.append(getattr(db, {"packed": "_h_packed",
                                    "resid": "_h_resid"}[name])[slots])
        elif port:
            out.append(db._gather_rows(name, slots, CPU).numpy())
        else:
            out.append(db._gather_rows(name, slots))
    return out


@pytest.mark.parametrize("raw,host_mirror", [(True, True), (True, False),
                                             (False, True), (False, False)])
def test_checkpoints_cross_both_ways(meshes, tmp_path, raw, host_mirror):
    """Dense (host mirrors) and ``payload_sharded`` (host_mirror=False)
    checkpoints, raw and compressed + residual: the reference's loads into
    the port on 8 and 4 shards with the reference's own slot layout and
    per-id state, and the port's loads into the reference."""
    vecs = _rows(1000, 32, 80, offset=0.3)
    kw = dict(dim=32, capacity=1024, num_subspaces=4, raw_store=raw,
              refine_residual=not raw, host_mirror=host_mirror)
    j, t = _pair(meshes, **kw)
    for db in (j, t):
        db.add_batch(np.arange(1000), vecs)
        for i in range(0, 1000, 9):
            db.remove(i)
        db.train_pq(num_centroids=16, iters=4)
    live_ids = np.asarray(sorted(t._slot_of))
    q = _rows(16, 32, 81, offset=0.3)
    for src, dst, port_src in ((j, sh.ShardedDatabase, False),
                               (t, ref_sh.ShardedDatabase, True)):
        path = str(tmp_path / f"from_{'port' if port_src else 'ref'}")
        src.save(path)
        want = _per_id(src, live_ids, port_src)
        for n_shards in (8, 4):
            jm, tm = meshes[n_shards]
            # the port's load next to the reference's own load of the file
            tl = sh.ShardedDatabase.load(tm, path, host_mirror=host_mirror)
            jl = ref_sh.ShardedDatabase.load(jm, path,
                                             host_mirror=host_mirror)
            _same_layout(jl, tl)
            for got, loaded, port in ((tl, tl, True), (jl, jl, False)):
                for a, b in zip(_per_id(got, live_ids, port), want):
                    np.testing.assert_array_equal(np.asarray(a), b)
            _same_search(tl.search(q, K), jl.search(q, K), rtol=1e-4)
            _same_search(tl.search_flagship(q, K, refine=64),
                         jl.search_flagship(q, K, refine=64), rtol=1e-4)


# --------------------------------------------------- checkpoint functions
def test_streamed_checkpoint_reads_everywhere(tmp_path):
    path = str(tmp_path / "stream")
    big = np.arange(12, dtype=np.int32).reshape(3, 4)
    calls = []

    def fetch(i):
        calls.append(i)
        return big * i

    ckpt.save_checkpoint_streamed(
        path, {"kind": "x", "n": 3}, {"a": np.ones(3), "nest": {"b": big}},
        [(f"lazy{i}", lambda i=i: fetch(i)) for i in range(3)])
    assert calls == [0, 1, 2]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert sorted(z.files) == ["a", "lazy0", "lazy1", "lazy2", "nest/b"]
        np.testing.assert_array_equal(z["lazy2"], big * 2)
    for opener in (ckpt.open_checkpoint_lazy, ref_ckpt.open_checkpoint_lazy):
        meta, z = opener(path)
        assert meta == {"kind": "x", "n": 3}
        np.testing.assert_array_equal(z["nest/b"], big)
        z.close()
    meta, arrays = ckpt.load_checkpoint(path)
    np.testing.assert_array_equal(arrays["nest"]["b"], big)
    # the reference's streamed file reads here too
    ref_ckpt.save_checkpoint_streamed(path, {"kind": "y"}, {},
                                      [("w", lambda: big)])
    meta, z = ckpt.open_checkpoint_lazy(path)
    np.testing.assert_array_equal(z["w"], big)
    z.close()


def test_absent_or_corrupt_checkpoint_is_none(tmp_path):
    assert ckpt.open_checkpoint_lazy(str(tmp_path / "none")) is None
    for junk in (b"not a zip", b"PK\x03\x04 truncated"):
        bad = tmp_path / f"bad{len(junk)}"
        bad.mkdir()
        (bad / "meta.json").write_text("{}")
        (bad / "arrays.npz").write_bytes(junk)
        assert ckpt.open_checkpoint_lazy(str(bad)) is None
    (bad / "meta.json").write_text("{not json")
    assert ckpt.open_checkpoint_lazy(str(bad)) is None


def test_make_mesh():
    mesh = sh.make_mesh(devices=["cpu"] * 3)
    assert mesh.size == 3 and mesh.devices == (CPU,) * 3
    assert sh.make_mesh(2, devices=[CPU] * 3).size == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sh.make_mesh()


def test_perm_import_from_a_balanced_index(meshes):
    """test_round3_fixes.py: codes and codebooks of a balance_dims index
    import with their permutation and keep recall."""
    from vector_db_tpu.api.config import HnswPqConfig
    from vector_db_tpu.index.hnsw_pq import HnswPqIndex

    n, dim = 512, 32
    vecs = (np.random.default_rng(42).standard_normal((n, dim))
            * (np.arange(dim) + 1.0) ** -1.0).astype(np.float32)
    idx = HnswPqIndex(dim, n, config=HnswPqConfig(
        num_subspaces=4, training_samples=256, balance_dims=True))
    idx.add_batch(list(range(n)), vecs)
    assert idx.trained and idx.perm is not None
    j, t = _pair(meshes, 4, vectors=vecs, ids=np.arange(n, dtype=np.int32),
                 valid=np.ones(n, bool), codes=np.asarray(idx.codes[:n]),
                 codebooks=np.asarray(idx.codebooks), num_subspaces=4,
                 perm=np.asarray(idx.perm))
    ext, _ = t.search_flagship(vecs[:8], 5, refine=64)
    np.testing.assert_array_equal(ext[:, 0], np.arange(8))
    _same_search(t.search_flagship(vecs[:64], 5, refine=64),
                 j.search_flagship(vecs[:64], 5, refine=64))
