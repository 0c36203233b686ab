"""The reference's fix suites on the port (copies of the reference's
``tests/test_round2_fixes.py`` from the cosine currency on,
``test_round3_fixes.py``, ``test_round4_fixes.py`` and
``test_round5_fixes.py``), on the CPU.

They hold the port to the contracts those rounds fixed: one cosine-distance
currency for every index type; LSH's metric, backfill counters, width
opt-in, bit rule, calibrated radius and table count; IVF's multi-assignment,
random fill and lossless quota + overflow member tables; the adaptive ef
policy; the sharded tier's imported permutation, water filling and pool
widths; config copies; a failed stream that leaves the index whole; pool
widths that survive the packed kernel's rounding; deferred graph inserts
with an exact overlay and the bounded flush (``flush_chunk``); Annoy's
beam and warning; the slot-0 scatter; the global int8 shadow's incremental
refresh and clip rebuild.

Where the reference's answer is deterministic (policies, table layouts,
widths, popcounts, exact searches) the same seeded numpy inputs also go
through ``vector_db_tpu`` and the two must agree.  Where the reference
reaches a private of the JAX package, the port's counterpart is used:
``_caches.scan8g.value`` is the port's (base8, off, sv, sgn, center, aux,
clipped) tuple, the
Annoy spy wraps ``annoy.descend``, meshes are ``make_mesh(devices=[cpu] *
n)``.  Torch's intra-op threads are capped (``_few_threads``): the cases
are small and run beside other test workers.
"""

import dataclasses
import inspect
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import vector_db_tpu as ref_vdb  # noqa: E402
from vector_db_torch import IndexType, VectorDatabase  # noqa: E402
from vector_db_torch.api.config import (AnnoyConfig, HnswConfig,  # noqa: E402
                                        HnswPqConfig, IvfConfig, LshConfig,
                                        PqConfig)
from vector_db_torch.index.annoy import AnnoyIndex  # noqa: E402
from vector_db_torch.index.brute import BruteForceIndex  # noqa: E402
from vector_db_torch.index.hnsw import HnswIndex  # noqa: E402
from vector_db_torch.index.hnsw_pq import HnswPqIndex  # noqa: E402
from vector_db_torch.index.ivf import IvfIndex  # noqa: E402
from vector_db_torch.index.lsh import _AUTO_TABLE_POOL, LshIndex  # noqa: E402
from vector_db_torch.ops.distance import blocked_knn  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cos_dist(a: np.ndarray, b: np.ndarray) -> float:
    return 1.0 - float(
        np.dot(a, b) / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12))


def _true_ids(idx, qs, k, metric="l2"):
    """Exact top-k external ids over an index's store (the port's
    ``blocked_knn``)."""
    st = idx.store.state
    _, slots = blocked_knn(torch.from_numpy(qs), st.vectors, st.valid, k,
                           metric=metric, b_norms=st.norms, block_n=4096)
    return st.ids[slots.long()].numpy()


def _recall(ids, gt):
    return float(np.mean([len(set(ids[i].tolist()) & set(gt[i].tolist()))
                          / gt.shape[1] for i in range(len(gt))]))


# ------------------------------------------------------------------ round 2
class TestCosineCurrency:
    """Every index reports the same cosine-distance currency, 1 - cos."""

    @pytest.mark.parametrize("itype,cfg", [
        (IndexType.BRUTE, None),
        (IndexType.HNSW, HnswConfig(m=8, ef_construction=64, ef_search=64)),
        (IndexType.PQ, PqConfig(num_subspaces=4, refine_k=0)),
        (IndexType.LSH, LshConfig(num_tables=8, num_bits=4,
                                  bucket_width=16.0)),
        (IndexType.IVF, None),
        (IndexType.ANNOY, None),
    ], ids=lambda v: getattr(v, "name", "cfg"))
    def test_reported_distance_is_true_cosine(self, rng, itype, cfg):
        vecs = rng.standard_normal((256, 16)).astype(np.float32)
        db = (VectorDatabase.builder().with_dimension(16)
              .with_max_elements(512).with_index_type(itype)
              .with_metric("cosine").with_index_config(cfg)
              .with_device(CPU).build())
        db.add_batch(range(len(vecs)), vecs)
        db.rebuild_index()
        q = vecs[7] * 3.0 + 0.01 * rng.standard_normal(16).astype(np.float32)
        results = db.search(q, 5)
        assert results, f"{itype} returned nothing"
        for r in results:
            want = _cos_dist(q, vecs[r.id])
            assert r.distance == pytest.approx(want, abs=5e-3), (
                f"{itype}: id {r.id} reported {r.distance}, true cosine {want}")
        if itype is IndexType.BRUTE:  # exact: the reference's answer
            ref = (ref_vdb.VectorDatabase.builder().with_dimension(16)
                   .with_max_elements(512)
                   .with_index_type(ref_vdb.IndexType.BRUTE)
                   .with_metric("cosine").build())
            ref.add_batch(range(len(vecs)), vecs)
            want = ref.search(q, 5)
            assert [r.id for r in results] == [r.id for r in want]
            np.testing.assert_allclose([r.distance for r in results],
                                       [r.distance for r in want],
                                       rtol=1e-5, atol=1e-6)


class TestLshRound2:
    def test_metric_passthrough_ranking(self, rng):
        """Cosine LSH ranks by cosine, not squared L2."""
        vecs = rng.standard_normal((128, 8)).astype(np.float32)
        idx = LshIndex(8, 256, "cosine",
                       LshConfig(num_tables=8, num_bits=2, bucket_width=64.0),
                       device=CPU)
        idx.add_batch(range(len(vecs)), vecs)
        ids, dists = idx.search(2.5 * vecs[11], 3)
        assert ids[0] == 11
        assert dists[0] == pytest.approx(0.0, abs=1e-5)

    def test_backfill_counter_and_disable(self, rng):
        vecs = rng.standard_normal((256, 8)).astype(np.float32)
        # microscopic bucket width => almost no collisions => backfill
        cfg = LshConfig(num_tables=2, num_bits=16, bucket_width=1e-4,
                        hamming_radius=0, backfill=False)
        idx = LshIndex(8, 256, "l2", cfg, device=CPU)
        idx.add_batch(range(len(vecs)), vecs)
        ids, _ = idx.search_batch(
            rng.standard_normal((4, 8)).astype(np.float32), 10)
        assert (ids < 0).any()  # honest: no silent exact-scan substitution
        assert idx.stats()["backfill_rows"] > 0
        assert idx.stats()["backfill_queries"] > 0

        cfg2 = dataclasses.replace(cfg, backfill=True)
        idx2 = LshIndex(8, 256, "l2", cfg2, device=CPU)
        idx2.add_batch(range(len(vecs)), vecs)
        ids2, _ = idx2.search_batch(
            rng.standard_normal((4, 8)).astype(np.float32), 10)
        assert (ids2 >= 0).all()  # the reference's random fill
        assert idx2.stats()["backfill_rows"] > 0  # but the event is counted


class TestIvfRound2:
    """IVF recall at nprobe=10 through multi-assignment, the random fill
    (no -1 rows) and the adaptive ef policy."""

    def test_recall_with_multi_assign(self, rng):
        n, dim, nq, k = 2048, 64, 64, 10
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        qs = rng.standard_normal((nq, dim)).astype(np.float32)
        gt = np.argsort(((qs[:, None, :] - vecs[None]) ** 2).sum(-1),
                        axis=1)[:, :k]
        idx = IvfIndex(dim, n, "l2", IvfConfig(num_clusters=100,
                                               num_probes=10), device=CPU)
        idx.add_batch(range(n), vecs)
        idx.build()
        ids, _ = idx.search_batch(qs, k)
        assert (ids >= 0).all()
        rec = _recall(ids, gt)
        assert rec >= 0.80, f"multi-assign recall {rec:.3f} < 0.80"

    def test_random_fill_no_negative_rows(self, rng):
        """Sparse probes and k larger than any cluster: rows still fill."""
        n, dim = 300, 16
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        idx = IvfIndex(dim, 512, "l2", IvfConfig(num_clusters=30,
                                                 num_probes=1,
                                                 multi_assign=1), device=CPU)
        idx.add_batch(range(n), vecs)
        idx.build()
        ids, dists = idx.search_batch(
            rng.standard_normal((4, dim)).astype(np.float32), 50)
        assert (ids >= 0).all()           # random fill: no -1 rows
        assert np.isfinite(dists).all()   # fills carry exact distances
        for row in dists:                 # merged output stays sorted
            assert (np.diff(row) >= -1e-5).all()

    def test_adaptive_ef_policy(self):
        cfg = HnswConfig()  # ef_search=0 -> adaptive
        assert cfg.ef_for_query(10, 100) == 42  # base only, no scaling
        assert cfg.ef_for_query(10, 1000) < cfg.ef_for_query(10, 50_000)
        assert cfg.ef_for_query(10, 10_000) <= 300
        assert cfg.ef_for_query(100, 100_000) == 400  # capped
        fixed = HnswConfig(ef_search=400)
        assert fixed.ef_for_query(10, 10**6) == 400
        assert fixed.ef_for_query(200, 100) == 800  # max(ef, 4k)


# ------------------------------------------------------------------ round 3
def _ref_member_table(*args, **kw):
    from vector_db_tpu.core.member_table import build_member_table

    return build_member_table(*args, **kw)


def _member_table(*args, **kw):
    """The port's table, held equal to the reference's on the same input."""
    from vector_db_torch.core.member_table import build_member_table

    got = build_member_table(*args, **kw)
    want = _ref_member_table(*args, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    return got


class TestMemberTable:
    def test_quota_overflow_lossless(self):
        # 1000 slots, 4 clusters, skewed: cluster 0 gets 900 slots
        cap = 1000
        assign = np.zeros(cap, np.int32)
        assign[900:] = np.arange(100) % 3 + 1
        valid = np.ones(cap, bool)
        table, max_len, over = _member_table(assign, valid, 4,
                                             quota_mult=2.0, align=8)
        in_table = set(table[table >= 0].tolist())
        in_over = set(over[over >= 0].tolist())
        assert in_table | in_over == set(range(cap))   # lossless
        assert not (in_table & in_over)                # disjoint
        assert max_len < 900                           # the mega-cluster capped
        assert table.shape[1] == max_len

    def test_multi_assign_pairs(self):
        assign = np.asarray([[0, 1], [0, -1], [1, 0], [-1, -1]], np.int32)
        valid = np.asarray([True, True, True, True])
        table, _, over = _member_table(assign, valid, 2, quota_mult=100.0,
                                       align=8)
        assert set(table[0][table[0] >= 0].tolist()) == {0, 1, 2}
        assert set(table[1][table[1] >= 0].tolist()) == {0, 2}
        assert (over == -1).all()

    def test_dead_slots_excluded(self):
        assign = np.asarray([0, 0, 1, 1], np.int32)
        valid = np.asarray([True, False, True, False])
        table, _, over = _member_table(assign, valid, 2)
        live = set(table[table >= 0].tolist()) | set(over[over >= 0].tolist())
        assert live == {0, 2}

    def test_vectorized_build_speed(self):
        """1M slots build in well under the old Python loop's ~30 s."""
        from vector_db_torch.core.member_table import build_member_table

        cap = 1_000_000
        r = np.random.default_rng(0)
        assign = r.integers(0, 1024, cap).astype(np.int32)
        valid = np.ones(cap, bool)
        t0 = time.time()
        table, max_len, over = build_member_table(assign, valid, 1024)
        dt = time.time() - t0
        assert dt < 3.0, f"member table build took {dt:.2f}s"
        covered = set(table[table >= 0].tolist()) | set(
            over[over >= 0].tolist())
        assert len(covered) == cap


class TestIvfSkewLossless:
    def test_skewed_corpus_keeps_recall(self, rng):
        """One dominant cluster: quota + overflow finds every member."""
        dim, n = 16, 2000
        blob = rng.standard_normal((1, dim)).astype(np.float32) * 0.1
        main = blob + 0.01 * rng.standard_normal((1900, dim)).astype(
            np.float32)
        rest = rng.standard_normal((100, dim)).astype(np.float32) + 5.0
        vecs = np.concatenate([main, rest]).astype(np.float32)
        idx = IvfIndex(dim, n, config=IvfConfig(num_clusters=20,
                                                num_probes=3,
                                                multi_assign=1), device=CPU)
        idx.add_batch(list(range(n)), vecs)
        idx.build()
        q = main[:32]
        ids, _ = idx.search_batch(q, 10)
        bf = BruteForceIndex(dim, n, device=CPU)
        bf.add_batch(list(range(n)), vecs)
        gt, _ = bf.search_batch(q, 10)
        assert _recall(ids, gt) >= 0.9


def _ef_grid():
    for k in (1, 10, 16, 100, 128, 200):
        for n in (100, 500, 1000, 10_000, 20_000, 50_000, 100_000, 10**6):
            for dim in (0, 128, 256, 512):
                yield k, n, dim


class TestDimAwareEf:
    def test_high_dim_floor(self):
        cfg = HnswConfig()
        # 128d keeps the old policy
        assert cfg.ef_for_query(10, 10_000, dim=128) == cfg.ef_for_query(
            10, 10_000)
        # 512d x 10k floors at >= 256
        assert cfg.ef_for_query(10, 10_000, dim=512) >= 256
        assert cfg.ef_for_query(10, 100_000, dim=512) >= 320
        # fixed mode unaffected
        assert HnswConfig(ef_search=64).ef_for_query(10, 10_000, dim=512) \
            == 64

    def test_small_n_unaffected(self):
        cfg = HnswConfig()
        assert cfg.ef_for_query(10, 500, dim=512) == cfg.ef_for_query(10, 500)

    @pytest.mark.parametrize("ef_search", [0, 64, 400])
    def test_policy_equals_reference(self, ef_search):
        from vector_db_tpu.api.config import HnswConfig as RefHnswConfig

        cfg, ref = HnswConfig(ef_search=ef_search), RefHnswConfig(
            ef_search=ef_search)
        for k, n, dim in _ef_grid():
            assert cfg.ef_for_query(k, n, dim=dim) == ref.ef_for_query(
                k, n, dim=dim), (k, n, dim)


class TestLshWidthOptIn:
    def test_explicit_width_means_exact_bucket(self):
        idx = LshIndex(32, 256, config=LshConfig(num_bits=8,
                                                 bucket_width=4.0),
                       device=CPU)
        assert idx._radius == 0
        assert idx._effective_width() == 4.0
        idx2 = LshIndex(32, 256, config=LshConfig(), device=CPU)
        assert idx2._sign_mode and idx2._radius is None


class TestShardedPermImport:
    def test_perm_roundtrip(self, rng):
        """Codes and codebooks exported from a balance_dims index import
        with their perm and keep recall."""
        from vector_db_torch.parallel import sharded as sh

        n, dim = 512, 32
        scale = ((np.arange(dim) + 1.0) ** -1.0).astype(np.float32)
        vecs = (rng.standard_normal((n, dim)) * scale).astype(np.float32)
        idx = HnswPqIndex(dim, n, config=HnswPqConfig(
            num_subspaces=4, training_samples=256, balance_dims=True),
            device=CPU)
        idx.add_batch(list(range(n)), vecs)
        assert idx.trained and idx.perm is not None
        mesh = sh.make_mesh(devices=[torch.device(CPU)] * 4)
        db = sh.ShardedDatabase(
            mesh, vecs, np.arange(n, dtype=np.int32), np.ones(n, bool),
            codes=idx.codes[:n].numpy(), codebooks=idx.codebooks.numpy(),
            num_subspaces=4, perm=idx.perm.numpy())
        ext, _ = db.search_flagship(vecs[:8], 5, refine=64)
        np.testing.assert_array_equal(ext[:, 0], np.arange(8))


class TestBuilderConfigImmutability:
    def test_shared_config_not_mutated(self):
        shared = HnswPqConfig(num_subspaces=4, training_samples=64)
        db = (VectorDatabase.builder()
              .with_dimension(16).with_max_elements(128)
              .with_index_type(IndexType.HNSWPQ)
              .with_index_config(shared)
              .with_search_mode("adc")
              .with_device(CPU).build())
        assert shared.search_mode == "auto"  # caller's object untouched
        assert db.index.config.search_mode == "adc"


class TestLshAutoRadius:
    """Scale-aware LSH defaults: bits from dim, the Hamming radius
    calibrated from true-neighbour code distances."""

    def test_bits_scale_with_dim(self):
        from vector_db_tpu.index.lsh import LshIndex as RefLshIndex

        cases = [(128, LshConfig(), 31), (512, LshConfig(), 31),
                 (512, LshConfig(num_bits=20), 20),
                 (128, LshConfig(bucket_width=4.0), 16),
                 (512, LshConfig(bucket_width=4.0), 24)]
        for dim, cfg, bits in cases:
            assert LshIndex(dim, 256, config=cfg, device=CPU)._bits == bits
            from vector_db_tpu.api.config import LshConfig as RefLshConfig

            ref_cfg = RefLshConfig(**dataclasses.asdict(cfg))
            assert RefLshIndex(dim, 256, config=ref_cfg)._bits == bits

    def test_auto_radius_calibrates_and_persists(self, rng):
        n, dim = 2048, 64
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        idx = LshIndex(dim, n, config=LshConfig(backfill=False), device=CPU)
        idx.add_batch(range(n), vecs)
        idx.build()
        q = rng.standard_normal((32, dim)).astype(np.float32)
        idx.search_batch(q, 5)  # triggers calibration
        r = idx.stats()["hamming_radius"]
        assert 1 <= r <= idx._bits // 2
        # the calibrated radius rides through checkpoint state
        idx2 = LshIndex(dim, n, config=LshConfig(backfill=False), device=CPU)
        idx2.load_state_arrays(idx.state_arrays())
        assert idx2._radius == r
        ids1, _ = idx.search_batch(q, 5)
        ids2, _ = idx2.search_batch(q, 5)
        np.testing.assert_array_equal(ids1, ids2)

    def test_explicit_radius_fixed(self):
        idx = LshIndex(512, 256, config=LshConfig(hamming_radius=5),
                       device=CPU)
        assert idx._radius == 5 and idx._sign_mode


class TestReviewFixes:
    """Water-filling balance, IVF blocked rerank, stream crash
    consistency, config aliasing, the exact int8 fallback."""

    def test_shared_config_not_mutated(self):
        cfg = HnswPqConfig(raw_store=False, num_subspaces=48)
        before = dataclasses.asdict(cfg)
        idx = HnswPqIndex(64, 256, config=cfg, device=CPU)
        assert dataclasses.asdict(cfg) == before  # caller object untouched
        assert idx.config.refine_store == "int8"  # private copy adjusted
        assert idx.config.num_subspaces == 32     # 64 % 48 != 0 -> down

    def test_sharded_water_filling_balanced(self):
        from vector_db_torch.parallel import sharded as sh
        from vector_db_tpu.parallel import sharded as ref_sh

        mesh = sh.make_mesh(devices=[torch.device(CPU)] * 4)
        ref_mesh = ref_sh.make_mesh(4)
        rng = np.random.default_rng(0)
        v1 = rng.standard_normal((100, 16)).astype(np.float32)
        v2 = rng.standard_normal((100, 16)).astype(np.float32)
        loads = []
        for mod, m in ((sh, mesh), (ref_sh, ref_mesh)):
            db = mod.ShardedDatabase(m, dim=16, capacity=4 * 64)
            db.add_batch(np.arange(100), v1)
            load = db._fill - np.asarray([len(f) for f in db._free])
            assert load.max() - load.min() <= 1, load.tolist()
            # uneven prior load: fills the lowest shards first
            db2 = mod.ShardedDatabase(m, dim=16, capacity=4 * 64)
            db2._fill[:] = [30, 5, 0, 60]
            db2.add_batch(np.arange(1000, 1100), v2)
            load2 = db2._fill - np.asarray([len(f) for f in db2._free])
            assert load2.tolist() == [45, 45, 45, 60]
            loads.append((load.tolist(), load2.tolist()))
        assert loads[0] == loads[1]

    def test_stream_failure_keeps_index_consistent(self):
        rng = np.random.default_rng(5)
        vecs = rng.standard_normal((1024, 32)).astype(np.float32)
        idx = HnswPqIndex(32, 2048, config=HnswPqConfig(
            num_subspaces=8, training_samples=512), device=CPU)
        # the second chunk repeats ids: fails BEFORE writing it
        with pytest.raises(ValueError, match="across chunks"):
            idx.bulk_load_stream([(range(512), vecs[:512]),
                                  (range(512), vecs[512:1024])])
        assert idx.size() == 512
        ids, _ = idx.search_batch(vecs[:4], 1)
        assert ids[:, 0].tolist() == [0, 1, 2, 3]
        # CRUD still works after the failed stream
        assert idx.add_batch([9000], vecs[-1:]) == [9000]
        assert idx.remove(9000)

    def test_int8_untrained_fallback_exact(self):
        rng = np.random.default_rng(6)
        vecs = rng.standard_normal((40, 32)).astype(np.float32)
        idx = HnswPqIndex(32, 512, config=HnswPqConfig(raw_store=False),
                          device=CPU)
        idx.add_batch(range(40), vecs)
        ids, _ = idx.search_batch(vecs[:2], 64)  # k > n_live
        # every live row comes back (the exhaustive path's guarantee)
        assert (np.sort(ids[0][ids[0] >= 0]) == np.arange(40)).all()

    def test_ivf_blocked_rerank_overflow(self, rng):
        """Half the corpus in one mega cluster: overflow candidates go
        through the blocked rerank and stay lossless."""
        n, dim = 3000, 16
        base = rng.standard_normal((n, dim)).astype(np.float32)
        base[: n // 2] *= 0.01
        idx = IvfIndex(dim, n, "l2", IvfConfig(num_clusters=30,
                                               num_probes=5), device=CPU)
        idx.add_batch(range(n), base)
        idx.build()
        ids, _ = idx.search_batch(base[:32] + 1e-4, 1)
        assert (ids[:, 0] == np.arange(32)).all()


# ------------------------------------------------------------------ round 4
class TestPreservedPoolWidth:
    def test_invariants_sweep(self):
        """Every width divides n and survives the kernel's rounding
        (w <= block_n, or w % block_n == 0), and equals the reference's."""
        from vector_db_torch.ops.kernels import LANES, preserved_pool_width
        from vector_db_tpu.ops.pallas_kernels import (
            preserved_pool_width as ref_width)

        for mult in range(1, 200):
            n = mult * LANES
            w = preserved_pool_width(n)
            assert n % w == 0, (n, w)
            assert w <= 2048
            assert w <= 512 or w % 512 == 0, (n, w)
            assert w == ref_width(n), n

    def test_advisor_cases(self):
        from vector_db_torch.ops.kernels import preserved_pool_width

        # per_shard 1920 (capacity 15360 over 8 shards): 384 is the widest
        assert preserved_pool_width(1920) == 384
        # a 128-rounded legacy capacity of 3200
        w = preserved_pool_width(3200)
        assert 3200 % w == 0 and (w <= 512 or w % 512 == 0)
        assert preserved_pool_width(2048) == 2048
        assert preserved_pool_width(1 << 20) == 2048

    def test_rejects_unaligned(self):
        from vector_db_torch.ops.kernels import preserved_pool_width

        with pytest.raises(ValueError):
            preserved_pool_width(1000)

    @pytest.mark.parametrize("n", [1920, 3200])
    def test_legacy_capacity_scan(self, n):
        """The compressed scan over a legacy 128-rounded capacity: shadow,
        packed pool and int8 refine run and find the true neighbour."""
        from vector_db_torch.index.hnsw_pq import (_build_scan8p_shadow,
                                                   pallas_scan8p_refine)
        from vector_db_torch.ops.distance import pack_int8_rows
        from vector_db_torch.ops.kernels import preserved_pool_width

        rng = np.random.default_rng(7)
        dim = 64
        vecs = torch.from_numpy(
            (rng.standard_normal((n, dim)) + 1.0).astype(np.float32))
        packed, scales = pack_int8_rows(vecs)
        norms = torch.sum(vecs * vecs, dim=1)
        valid = torch.ones(n, dtype=torch.bool)
        ids = torch.arange(n, dtype=torch.int32)
        off, sc, cvec = _build_scan8p_shadow(packed, scales, norms, valid,
                                             "l2")
        q = vecs[:4] + 0.01 * torch.from_numpy(
            rng.standard_normal((4, dim)).astype(np.float32))
        w = preserved_pool_width(n)
        _, ext = pallas_scan8p_refine(q, packed, scales, norms, off, sc,
                                      cvec, ids, k=8, metric="l2", pool=64,
                                      w=w)
        assert (ext[:, 0].numpy() == np.arange(4)).all(), ext[:, 0]


class TestShardedFusedWidth:
    def test_per_shard_1920_search_fused(self):
        """ShardedDatabase(capacity=15360, raw_store=False).search_fused
        with per_shard 1920, which the kernel's width rounding once
        refused."""
        from vector_db_torch.parallel import sharded as sh

        mesh = sh.make_mesh(devices=[torch.device(CPU)] * 8)
        rng = np.random.default_rng(11)
        n, dim = 15360, 64
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n, raw_store=False)
        assert db.per_shard == 1920
        vecs = (rng.standard_normal((4096, dim)) + 1.0).astype(np.float32)
        db.add_batch(np.arange(4096), vecs)
        q = vecs[:8] + 0.01 * rng.standard_normal((8, dim)).astype(
            np.float32)
        ext, _ = db.search_fused(q, 5)
        hits = np.mean([int(ext[i, 0] == i) for i in range(8)])
        assert hits >= 0.9, (hits, ext[:, 0])


class TestTakeDirtyGuard:
    def test_all_empty_records(self):
        """A dirty record of only empty arrays yields None (rebuild), not
        an IndexError or an empty refresh."""
        idx = HnswPqIndex(dim=32, capacity=256, config=HnswPqConfig(),
                          device=CPU)
        cache = idx._caches.scan8
        cache.get(0, lambda: "built")
        cache.note(np.zeros(0, np.int64), 8192)
        cache.note(np.zeros(0, np.int64), 8192)
        refreshed = []
        assert cache.get(1, lambda: "rebuilt",
                         lambda v, s: refreshed.append(s)) == "rebuilt"
        assert not refreshed

    def test_record_counts_rows_as_it_grows(self):
        """Each write adds its rows to the record's running count (no sum
        over the record a write), and past max(8192, capacity / 8) rows the
        record becomes void: the next search rebuilds."""
        idx = HnswPqIndex(dim=8, capacity=1024, config=HnswPqConfig(
            num_subspaces=2, training_samples=256), device=CPU)
        idx.add_batch(range(600), np.ones((600, 8), np.float32))
        idx.search_batch(np.zeros((1, 8), np.float32), 1)
        rows = idx._caches[:5]  # the row-keyed caches
        for cache in rows:
            cache._take()  # an empty record
        for vid in range(300):
            assert idx.remove(vid)
        for cache in rows:
            assert cache._rows == sum(a.size for a in cache._record) == 300
        idx._note_row_mutation(np.arange(8192 - 300 + 1))
        assert all(cache._record is None for cache in rows)


class TestDeferInsertPolicy:
    """Incremental graph adds ride a pending buffer with an exact overlay,
    flushed in bulk by exact-kNN delta insertion."""

    def _cfg(self, **kw):
        return HnswConfig(m=8, ef_construction=64, **kw)

    def test_pending_visible_before_flush(self):
        rng = np.random.default_rng(3)
        idx = HnswIndex(16, 2048, "l2", self._cfg(flush_min=4096),
                        device=CPU)
        vecs = rng.standard_normal((600, 16)).astype(np.float32)
        idx.add_batch(range(300), vecs[:300])
        idx.flush_pending()
        idx.add_batch(range(300, 600), vecs[300:])
        assert idx.stats()["pending_inserts"] == 300
        ids, _ = idx.search_batch(vecs[450:460], 1)
        assert (ids[:, 0] == np.arange(450, 460)).all()

    def test_flush_threshold_triggers(self):
        rng = np.random.default_rng(4)
        idx = HnswIndex(16, 1024, "l2", self._cfg(flush_min=64), device=CPU)
        vecs = rng.standard_normal((512, 16)).astype(np.float32)
        for s in range(0, 512, 32):
            idx.add_batch(range(s, s + 32), vecs[s:s + 32])
        pending = idx.stats()["pending_inserts"]
        connected = int((idx.graph.levels >= 0).sum())
        assert connected + pending == 512
        assert connected >= 384 and pending < 128

    def test_incremental_recall_matches_rebuild(self):
        rng = np.random.default_rng(5)
        n, dim = 2048, 32
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        q = vecs[:64] + 0.05 * rng.standard_normal((64, dim)).astype(
            np.float32)
        gt = np.argsort(((q[:, None, :] - vecs[None, :, :]) ** 2).sum(-1),
                        1)[:, :10]
        inc = HnswIndex(dim, n, "l2", self._cfg(flush_min=256), device=CPU)
        for s in range(0, n, 128):
            inc.add_batch(range(s, s + 128), vecs[s:s + 128])
        reb = HnswIndex(dim, n, "l2", self._cfg(), device=CPU)
        reb.add_batch(range(n), vecs)
        reb.build()
        r_inc = _recall(inc.search_batch(q, 10)[0], gt)
        r_reb = _recall(reb.search_batch(q, 10)[0], gt)
        assert r_inc >= r_reb - 0.01, (r_inc, r_reb)

    def test_remove_pending(self):
        rng = np.random.default_rng(6)
        idx = HnswIndex(16, 512, "l2", self._cfg(flush_min=4096), device=CPU)
        vecs = rng.standard_normal((300, 16)).astype(np.float32)
        idx.add_batch(range(200), vecs[:200])
        idx.flush_pending()
        idx.add_batch(range(200, 300), vecs[200:])
        assert idx.remove(250)
        assert idx.stats()["pending_inserts"] == 99
        ids, _ = idx.search(vecs[250], 1)
        assert ids[0] != 250

    def test_checkpoint_flushes(self):
        rng = np.random.default_rng(8)
        idx = HnswIndex(16, 512, "l2", self._cfg(flush_min=4096), device=CPU)
        vecs = rng.standard_normal((300, 16)).astype(np.float32)
        idx.add_batch(range(300), vecs)
        arrays = idx.state_arrays()
        assert idx.stats()["pending_inserts"] == 0
        idx2 = HnswIndex(16, 512, "l2", self._cfg(), device=CPU)
        idx2.load_state_arrays(arrays)
        ids, _ = idx2.search_batch(vecs[:16], 1)
        assert (ids[:, 0] == np.arange(16)).mean() >= 0.9

    def test_stream_policy_unchanged(self):
        rng = np.random.default_rng(9)
        idx = HnswIndex(16, 512, "l2", self._cfg(insert_policy="stream"),
                        device=CPU)
        vecs = rng.standard_normal((200, 16)).astype(np.float32)
        idx.add_batch(range(200), vecs)
        assert idx.stats()["pending_inserts"] == 0
        assert int((idx.graph.levels >= 0).sum()) == 200

    def test_hnswpq_graph_defer(self):
        rng = np.random.default_rng(10)
        n, dim = 1024, 32
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        cfg = HnswPqConfig(num_subspaces=8, training_samples=512,
                           use_graph=True, search_mode="graph",
                           flush_min=4096, m=8)
        idx = HnswPqIndex(dim, n, "l2", cfg, device=CPU)
        idx.add_batch(range(512), vecs[:512])   # trains and builds
        assert idx.trained
        idx.add_batch(range(512, n), vecs[512:])
        assert idx.stats()["pending_inserts"] == 512
        ids, _ = idx.search_batch(vecs[700:710], 1)
        assert (ids[:, 0] == np.arange(700, 710)).mean() >= 0.9
        idx.flush_pending()
        assert idx.stats()["pending_inserts"] == 0
        ids, _ = idx.search_batch(vecs[700:710], 1)
        assert (ids[:, 0] == np.arange(700, 710)).mean() >= 0.9


class TestLshPercentileDoc:
    def test_docstring_matches_code(self):
        """The docstring and the code agree on the percentile."""
        src = inspect.getsource(LshIndex._auto_radius)
        doc = LshIndex._auto_radius.__doc__
        assert "75.0" in src
        assert "75th" in doc and "65th" not in doc


class TestLshAutoTables:
    """num_tables=0 calibrates the table count with the radius from a
    32-table pool, under a random-collision mass budget."""

    def _corpus(self, rng, n, dim):
        return rng.standard_normal((n, dim)).astype(np.float32)

    def test_calibration_truncates_pool_and_persists(self, rng):
        n, dim = 2048, 64
        vecs = self._corpus(rng, n, dim)
        idx = LshIndex(dim, n, config=LshConfig(backfill=False), device=CPU)
        assert idx.stats()["num_tables"] == _AUTO_TABLE_POOL  # pool pre-cal
        idx.add_batch(range(n), vecs)
        idx.build()
        q = self._corpus(rng, 32, dim)
        idx.search_batch(q, 5)  # triggers the joint calibration
        s = idx.stats()
        assert 2 <= s["num_tables"] <= _AUTO_TABLE_POOL
        assert idx.planes.shape[0] == s["num_tables"]
        assert idx.bucket_ids.shape[0] == s["num_tables"]
        assert s["hamming_radius"] >= 1
        # the table choice and the radius ride through checkpoints
        idx2 = LshIndex(dim, n, config=LshConfig(backfill=False), device=CPU)
        idx2.load_state_arrays(idx.state_arrays())
        assert idx2._tables == s["num_tables"] and idx2._tables_final
        ids1, _ = idx.search_batch(q, 5)
        ids2, _ = idx2.search_batch(q, 5)
        np.testing.assert_array_equal(ids1, ids2)

    def test_build_recalibrates(self, rng):
        n, dim = 1024, 32
        idx = LshIndex(dim, n, config=LshConfig(backfill=False), device=CPU)
        idx.add_batch(range(n), self._corpus(rng, n, dim))
        idx.build()
        idx.search_batch(self._corpus(rng, 8, dim), 3)
        assert idx._tables_final
        idx.build()  # regenerates the full pool, re-arms calibration
        assert not idx._tables_final
        assert idx.planes.shape[0] == _AUTO_TABLE_POOL
        idx.search_batch(self._corpus(rng, 8, dim), 3)
        assert idx._tables_final

    def test_explicit_tables_stay_fixed(self, rng):
        n, dim = 1024, 32
        idx = LshIndex(dim, n, config=LshConfig(num_tables=6,
                                                backfill=False), device=CPU)
        idx.add_batch(range(n), self._corpus(rng, n, dim))
        idx.build()
        idx.search_batch(self._corpus(rng, 8, dim), 3)
        assert idx.stats()["num_tables"] == 6
        assert idx.planes.shape[0] == 6

    def test_fixed_radius_still_calibrates_tables(self, rng):
        n, dim = 1024, 32
        idx = LshIndex(dim, n, config=LshConfig(hamming_radius=5,
                                                backfill=False), device=CPU)
        assert idx._radius == 5
        idx.add_batch(range(n), self._corpus(rng, n, dim))
        idx.build()
        idx.search_batch(self._corpus(rng, 8, dim), 3)
        assert idx._radius == 5  # radius respected
        assert idx._tables_final  # tables still calibrated

    def test_auto_beats_static_ten_at_high_dim(self, rng):
        """At high dim the calibrated config takes more than the old
        static 10 tables and is never meaningfully worse."""
        n, dim, k = 4096, 256, 10
        vecs = self._corpus(rng, n, dim)
        qs = self._corpus(rng, 64, dim)

        def recall(cfg):
            idx = LshIndex(dim, n, "l2", cfg, device=CPU)
            idx.add_batch(range(n), vecs)
            idx.build()
            ids, _ = idx.search_batch(qs, k)
            return (_recall(ids, _true_ids(idx, qs, k)),
                    idx.stats()["num_tables"])

        r_auto, t_auto = recall(LshConfig(backfill=False))
        r_old, _ = recall(LshConfig(num_tables=10, num_bits=24,
                                    backfill=False))
        assert t_auto > 10
        assert r_auto >= r_old - 0.02
        assert r_auto >= 0.60  # honest floor at isotropic 256d x 4k


class TestAnnoyDefaultBeam:
    """search_k=0 resolves through the auto beam: 128 at or below 256
    dims (the reference config), 512 above."""

    def test_default_beam_is_128(self):
        src = inspect.getsource(AnnoyIndex.beam)
        assert "search_k or auto_beam" in src
        assert "512 if self.dim > HIGH_DIM_THRESHOLD else 128" in src
        assert AnnoyIndex(64, 256, "l2", AnnoyConfig(), device=CPU).beam() \
            == 128
        assert AnnoyIndex(64, 256, "l2", AnnoyConfig(search_k=32),
                          device=CPU).beam() == 32

    def test_honest_recall_at_scaled_reference_config(self, rng):
        n, dim, k = 4096, 128, 10
        vecs = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
        qs = rng.uniform(-1, 1, (32, dim)).astype(np.float32)
        idx = AnnoyIndex(dim, n, "l2", AnnoyConfig(backfill=False),
                         device=CPU)
        idx.add_batch(range(n), vecs)
        idx.build()
        ids, _ = idx.search_batch(qs, k)
        assert _recall(ids, _true_ids(idx, qs, k)) >= 0.90


class TestInt8GlobalEpilogue:
    """int8_epilogue="global": scan_pallas_int8 through the integer
    epilogue pool (global-scale shadow), with the same pool + exact refine
    contract."""

    def _index(self, rng, n=3000, dim=64, metric="l2"):
        cfg = HnswPqConfig(num_subspaces=8, training_samples=512,
                           use_graph=False, search_mode="scan_pallas_int8",
                           int8_epilogue="global")
        idx = HnswPqIndex(dim, n, metric, cfg, device=CPU)
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        idx.add_batch(range(n), vecs)
        return idx, vecs

    @pytest.mark.parametrize("metric", ["l2", "cosine"])
    def test_recall_vs_brute(self, rng, metric):
        idx, vecs = self._index(rng, metric=metric)
        qs = rng.standard_normal((32, 64)).astype(np.float32)
        ids, _ = idx.search_batch(qs, 10)
        assert _recall(ids, _true_ids(idx, qs, 10, metric)) >= 0.95

    def test_incremental_shadow_after_churn(self, rng):
        """Adds and removes after the first search refresh the global
        shadow in place (dirty slots at the cached sv) and keep results
        exact for the surviving rows."""
        idx, vecs = self._index(rng)
        qs = vecs[100:108] + 0.01 * rng.standard_normal((8, 64)).astype(
            np.float32)
        idx.search_batch(qs, 5)  # builds the shadow cache
        assert idx._caches.scan8g.value is not None
        for vid in range(100, 104):
            assert idx.remove(vid)
        new = rng.standard_normal((4, 64)).astype(np.float32)
        idx.add_batch(range(5000, 5004), new)
        ids, _ = idx.search_batch(qs[:4], 5)
        assert not ({100, 101, 102, 103} & set(ids.ravel().tolist()))
        ids2, _ = idx.search_batch(new, 1)
        assert (ids2[:, 0] == np.arange(5000, 5004)).all()


class TestSlotZeroScatterClobber:
    """Padded forward-edge scatters of a batch holding store slot 0 must
    not overwrite slot 0's fresh edges with a stale row."""

    def test_bulk_insert_delta_slot0_keeps_edges(self):
        import vector_db_torch.ops.hnsw_graph as hg

        n, d, m = 48, 16, 4
        r = np.random.default_rng(0)
        base = torch.from_numpy(r.standard_normal((n, d)).astype(np.float32))
        norms = torch.sum(base * base, dim=1)
        valid = torch.ones(n, dtype=torch.bool)
        g = hg.init_graph(n, m, 4, CPU)
        old = np.arange(3, n, dtype=np.int32)  # a graph over slots 3..47
        g = hg.bulk_build(g, base, norms, old, np.zeros(old.size, np.int32),
                          m=m)
        news = np.asarray([0, 1, 2], np.int32)  # a delta holding slot 0
        g = hg.bulk_insert_delta(g, base, norms, valid, news,
                                 np.zeros(3, np.int32), m=m)
        row0 = g.neighbors[0, 0].numpy()
        assert (row0 >= 0).any(), "slot 0 lost its forward edges to pads"
        full = (norms + norms[0] - 2.0 * (base @ base[0])).numpy()
        full[0] = np.inf
        true10 = set(np.argsort(full)[:10].tolist())
        assert set(row0[row0 >= 0].tolist()) & true10

    def test_bulk_build_slot0_keeps_edges(self):
        import vector_db_torch.ops.hnsw_graph as hg

        n, d, m = 40, 16, 4
        r = np.random.default_rng(1)
        base = torch.from_numpy(r.standard_normal((n, d)).astype(np.float32))
        norms = torch.sum(base * base, dim=1)
        g = hg.init_graph(n, m, 4, CPU)
        g = hg.bulk_build(g, base, norms, np.arange(n, dtype=np.int32),
                          np.zeros(n, np.int32), m=m)
        row0 = g.neighbors[0, 0].numpy()
        assert (row0 >= 0).any(), "slot 0 lost its forward edges to pads"


# ------------------------------------------------------------------ round 5
class TestGraphPendingOverlay:
    """Pending slots merge through one [Q, P] product, not a [Q, R+P, d]
    gather."""

    @pytest.mark.parametrize("metric", ["l2", "cosine"])
    @pytest.mark.parametrize("n_pend", [64, 512])
    def test_matches_oracle(self, rng, metric, n_pend):
        from vector_db_torch.index.hnsw_pq import _graph_refine_pending

        n, d, q_n, r, k = 2048, 32, 16, 64, 8
        base = rng.standard_normal((n, d)).astype(np.float32)
        queries = rng.standard_normal((q_n, d)).astype(np.float32)
        perm = rng.permutation(n)
        cand = np.sort(perm[: r * q_n].reshape(q_n, r), axis=1).astype(
            np.int32)
        cand[:, -2:] = -1
        pending = perm[r * q_n: r * q_n + n_pend].astype(np.int32).copy()
        pending[-3:] = -1
        d_out, s_out = _graph_refine_pending(
            torch.from_numpy(queries), torch.from_numpy(base),
            torch.ones(n, dtype=torch.bool), torch.from_numpy(cand),
            torch.from_numpy(pending), k, metric)
        d_out, s_out = d_out.numpy(), s_out.numpy()
        for i in range(q_n):
            pool = np.concatenate([cand[i], pending])
            pool = np.unique(pool[pool >= 0])
            if metric == "l2":
                dist = ((base[pool] - queries[i]) ** 2).sum(1)
            else:
                dist = 1.0 - (base[pool] @ queries[i]) / np.maximum(
                    np.linalg.norm(base[pool], axis=1)
                    * np.linalg.norm(queries[i]), 1e-12)
            want = set(pool[np.argsort(dist)[:k]].tolist())
            assert len(set(s_out[i].tolist()) & want) >= k - 1, i
            assert (np.diff(d_out[i]) >= -1e-5).all()

    def test_search_with_pending_matches_flush(self, rng):
        n, dim = 1536, 32
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        cfg = HnswPqConfig(num_subspaces=8, training_samples=512,
                           use_graph=True, search_mode="graph",
                           flush_min=4096, m=8)
        idx = HnswPqIndex(dim, n, "l2", cfg, device=CPU)
        idx.add_batch(range(512), vecs[:512])
        idx.add_batch(range(512, n), vecs[512:])
        assert idx.stats()["pending_inserts"] == n - 512
        ids, _ = idx.search_batch(vecs[900:916], 1)
        assert (ids[:, 0] == np.arange(900, 916)).mean() >= 0.9


class TestPopcountFallback:
    """NumPy 1.x has no np.bitwise_count."""

    def test_fallback_matches(self, rng, monkeypatch):
        from vector_db_torch.index import lsh
        from vector_db_tpu.index import lsh as ref_lsh

        x = rng.integers(-2**31, 2**31, size=(13, 7)).astype(np.int32)
        want = np.array([[bin(int(v)).count("1") for v in row]
                         for row in x.view(np.uint32)])
        assert (lsh._popcount(x) == want).all()
        assert (ref_lsh._popcount(x) == want).all()
        monkeypatch.delattr(np, "bitwise_count")
        assert (lsh._popcount(x) == want).all()

    def test_default_lsh_search_without_bitwise_count(self, rng,
                                                      monkeypatch):
        """The default (auto tables) index calibrates at first search
        without NumPy 2.0."""
        monkeypatch.delattr(np, "bitwise_count")
        n, dim = 512, 16
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        idx = LshIndex(dim, n, "l2", LshConfig(), device=CPU)
        idx.add_batch(range(n), vecs)
        ids, _ = idx.search_batch(vecs[:8], 1)
        assert (ids[:, 0] == np.arange(8)).mean() >= 0.9


class TestAnnoyHighDimWarning:
    """Annoy warns once at high dim and says so in stats()."""

    @pytest.mark.parametrize("dim,warns", [(512, True), (64, False)])
    def test_warns_once_and_flags_stats(self, rng, caplog, dim, warns):
        n = 256
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        idx = AnnoyIndex(dim, n, "l2", AnnoyConfig(), device=CPU)
        with caplog.at_level("WARNING", logger="vector_db_torch.index.annoy"):
            idx.add_batch(range(n), vecs)
            idx.build()
            idx.build()  # a second build does not warn again
        got = [r for r in caplog.records if "HNSWPQ" in r.message]
        assert len(got) == int(warns), [r.message for r in caplog.records]
        assert idx.stats()["high_dim"] is warns

    def test_auto_beam_widens_at_high_dim(self, rng, monkeypatch):
        """search_k=0 resolves to beam 512 above the dim threshold and
        stays 128 below it."""
        from vector_db_torch.index import annoy as annoy_mod

        seen = {}
        orig = annoy_mod.descend

        def spy(queries, hyperplanes, thresholds, children, max_depth, beam,
                *rest):
            seen["beam"] = beam
            return orig(queries, hyperplanes, thresholds, children,
                        max_depth, beam, *rest)

        monkeypatch.setattr(annoy_mod, "descend", spy)
        for dim, want in ((512, 512), (64, 128)):
            n = 384
            idx = AnnoyIndex(dim, n, "l2", AnnoyConfig(), device=CPU)
            idx.add_batch(range(n),
                          rng.standard_normal((n, dim)).astype(np.float32))
            idx.build()
            idx.search_batch(rng.standard_normal((4, dim)).astype(
                np.float32), 5)
            assert seen["beam"] == want, (dim, seen)

    def test_wide_candidate_rerank_matches_narrow(self, rng):
        """Past 8,192 candidates the re-rank goes through blocked_rerank;
        the results equal the narrow path's on the same candidates."""
        from vector_db_torch.index.annoy import _rerank

        n, d, q_n, k = 4096, 16, 8, 5
        base = rng.standard_normal((n, d)).astype(np.float32)
        qs = rng.standard_normal((q_n, d)).astype(np.float32)
        valid = np.ones(n, bool)
        valid[7] = False
        cand_small = rng.integers(0, n, size=(q_n, 4096)).astype(np.int32)
        cand_small[:, -5:] = -1
        cand_wide = np.concatenate(
            [cand_small, np.full((q_n, 16384 - 4096), -1, np.int32)], axis=1)
        args = (torch.from_numpy(qs), torch.from_numpy(base),
                torch.from_numpy((base ** 2).sum(1)), torch.from_numpy(valid))
        d_n, s_n = _rerank(*args, torch.from_numpy(cand_small), k)
        d_w, s_w = _rerank(*args, torch.from_numpy(cand_wide), k)
        assert torch.equal(s_n, s_w)
        np.testing.assert_allclose(d_n.numpy(), d_w.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert 7 not in set(s_w.numpy().ravel().tolist())


class TestScan8gClipRebuild:
    """Rows clipped against the global shadow's cached scale are counted,
    and a non-trivial share of them forces a rebuild (a new sv)."""

    def _index(self, rng, n_cap=6000, n=3000, dim=64):
        cfg = HnswPqConfig(num_subspaces=8, training_samples=512,
                           use_graph=False, search_mode="scan_pallas_int8",
                           int8_epilogue="global")
        idx = HnswPqIndex(dim, n_cap, "l2", cfg, device=CPU)
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        idx.add_batch(range(n), vecs)
        return idx, vecs

    @staticmethod
    def _sv(idx):
        return float(idx._caches.scan8g.value[2])

    def test_many_clipped_rows_trigger_rebuild(self, rng):
        idx, vecs = self._index(rng)
        idx.search_batch(vecs[:8], 5)
        assert idx._caches.scan8g.value is not None
        sv0 = self._sv(idx)
        # 128 rows far outside the calibrated range (> max(64, 1% of N))
        wide = 10.0 * rng.standard_normal((128, 64)).astype(np.float32)
        idx.add_batch(range(9000, 9128), wide)
        idx.search_batch(vecs[:8], 5)  # counts the clips -> rebuild
        sv1 = self._sv(idx)
        assert sv1 > sv0 * 2, (sv0, sv1)
        assert idx._caches.scan8g.value[-1] == 0  # clipped since built
        ids, _ = idx.search_batch(wide[:8], 1)
        assert (ids[:, 0] == np.arange(9000, 9008)).all()

    def test_few_clipped_rows_accumulate_without_rebuild(self, rng):
        idx, vecs = self._index(rng)
        idx.search_batch(vecs[:4], 5)
        sv0 = self._sv(idx)
        wide = 10.0 * rng.standard_normal((8, 64)).astype(np.float32)
        idx.add_batch(range(9000, 9008), wide)
        idx.search_batch(vecs[:4], 5)
        assert self._sv(idx) == sv0  # no rebuild
        assert 0 < idx._caches.scan8g.value[-1] <= 8

    def test_global_shadow_containment_at_100k(self, rng):
        """The global-scale shadow's pool at 100k x 512, scored with the
        kernel's formula (off_i - q8 . v8) in plain torch, holds the true
        top-10 within a 2,048-wide pool at >= 99%."""
        from vector_db_torch.index.hnsw_pq import _build_scan8g_shadow
        from vector_db_torch.ops.kernels import int8_cross

        n, dim, q_n, k, w = 100_000, 512, 64, 10, 2048
        scale = ((np.arange(dim) + 1.0) ** -0.5).astype(np.float32)
        vecs = torch.from_numpy(rng.standard_normal((n, dim)).astype(
            np.float32) * scale[None, :])
        qs = torch.from_numpy(rng.standard_normal((q_n, dim)).astype(
            np.float32) * scale[None, :])
        norms = torch.sum(vecs * vecs, dim=1)
        valid = torch.ones(n, dtype=torch.bool)
        base8, off, sv, sgn, cvec, _ = _build_scan8g_shadow(
            vecs, norms, valid, "l2", 128)
        qc = qs - cvec[None, :]
        sq = torch.clamp(torch.max(torch.abs(qc)), min=1e-12) / 127.0
        q8 = torch.clamp(torch.round(qc / sq), -127, 127).to(torch.int8)
        c = float(sgn) * sv * sq
        lim = float(1 << 26)
        off_i = torch.where(torch.isfinite(off),
                            torch.clamp(torch.round(off / c), -lim, lim),
                            float(1 << 29)).to(torch.int32)
        score = off_i[:n][None, :] - int8_cross(q8, base8[:n])
        pool = torch.argsort(score, dim=1)[:, :w].numpy()
        d_true = (torch.sum(qs * qs, 1)[:, None] + norms[None, :]
                  - 2.0 * qs @ vecs.T)
        gt = torch.argsort(d_true, dim=1)[:, :k].numpy()
        cont = np.mean([len(set(pool[i]) & set(gt[i])) / k
                        for i in range(q_n)])
        assert cont >= 0.99, cont


class TestHighDimLargeNBeam:
    """The adaptive ef widens past 20k rows at high dim."""

    def test_wide_beam_at_high_dim_large_n(self):
        cfg = HnswConfig()
        assert cfg.ef_for_query(16, 50_000, dim=512) == 768
        assert cfg.ef_for_query(16, 50_000, dim=256) == 512
        assert cfg.ef_for_query(16, 10_000, dim=512) == 288
        assert cfg.ef_for_query(16, 50_000, dim=128) == 128
        assert cfg.ef_for_query(100, 100_000, dim=0) == 400

    def test_java_4k_floor_never_clipped_by_adaptive_cap(self):
        assert HnswConfig().ef_for_query(128, 10_000, dim=128) >= 4 * 128


class TestBoundedFlush:
    """``flush_chunk > 0`` caps the pending slots a threshold flush
    connects per add_batch call (``index/base.DeferInsertMixin``); the
    rest drain on later adds and stay exactly searchable meanwhile."""

    def _cfg(self, **kw):
        return HnswConfig(m=8, ef_construction=64, **kw)

    def test_chunked_flush_caps_per_call_and_drains(self, rng):
        idx = HnswIndex(16, 2048, "l2",
                        self._cfg(flush_min=256, flush_chunk=64), device=CPU)
        vecs = rng.standard_normal((1024, 16)).astype(np.float32)
        # a connected graph first, so the delta path runs
        idx.add_batch(range(512), vecs[:512])
        idx.flush_pending()
        base_connected = int((idx.graph.levels >= 0).sum())
        assert base_connected == 512
        # crossing the threshold connects exactly ONE chunk a call
        idx.add_batch(range(512, 768), vecs[512:768])
        connected = int((idx.graph.levels >= 0).sum())
        assert connected == base_connected + 64
        assert idx.stats()["pending_inserts"] == 192
        idx.add_batch(range(768, 832), vecs[768:832])
        assert int((idx.graph.levels >= 0).sum()) == connected + 64
        ids, _ = idx.search_batch(vecs[800:808], 1)
        assert (ids[:, 0] == np.arange(800, 808)).all()
        # an explicit unbounded flush connects everything
        idx.flush_pending()
        assert idx.stats()["pending_inserts"] == 0
        assert int((idx.graph.levels >= 0).sum()) == 832

    def test_limit_ge_pending_clears_all(self, rng):
        idx = HnswIndex(16, 512, "l2", self._cfg(flush_min=4096), device=CPU)
        idx.add_batch(range(100),
                      rng.standard_normal((100, 16)).astype(np.float32))
        idx.flush_pending(limit=100)
        assert idx.stats()["pending_inserts"] == 0

    def test_chunked_recall_matches_full_flush(self, rng):
        n, dim = 1024, 32
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        q = vecs[:32] + 0.05 * rng.standard_normal((32, dim)).astype(
            np.float32)
        gt = np.argsort(((q[:, None, :] - vecs[None, :, :]) ** 2).sum(-1),
                        1)[:, :10]
        chunked = HnswIndex(dim, n, "l2",
                            self._cfg(flush_min=128, flush_chunk=64),
                            device=CPU)
        full = HnswIndex(dim, n, "l2", self._cfg(flush_min=128), device=CPU)
        for s in range(0, n, 64):
            chunked.add_batch(range(s, s + 64), vecs[s:s + 64])
            full.add_batch(range(s, s + 64), vecs[s:s + 64])
        rc = _recall(chunked.search_batch(q, 10)[0], gt)
        rf = _recall(full.search_batch(q, 10)[0], gt)
        assert rc >= rf - 0.02  # the overlay keeps pending rows exact

    def test_hnsw_pq_chunked_flush(self, rng):
        idx = HnswPqIndex(dim=32, capacity=1024, config=HnswPqConfig(
            m=8, ef_construction=64, use_graph=True,
            flush_min=128, flush_chunk=32), device=CPU)
        vecs = rng.standard_normal((512, 32)).astype(np.float32)
        idx.add_batch(range(256), vecs[:256])
        idx.flush_pending()
        idx.add_batch(range(256, 384), vecs[256:384])  # one chunk
        assert idx.stats()["pending_inserts"] == 96
        ids, _ = idx.search_batch(vecs[300:308], 1)
        assert (ids[:, 0] == np.arange(300, 308)).all()

    def test_chunked_flush_from_empty_graph(self, rng):
        """The first crossing with an EMPTY graph builds it from the chunk;
        the rest stay pending."""
        idx = HnswIndex(16, 1024, "l2",
                        self._cfg(flush_min=128, flush_chunk=64), device=CPU)
        vecs = rng.standard_normal((256, 16)).astype(np.float32)
        idx.add_batch(range(256), vecs)
        assert idx.graph.entry >= 0  # the chunk built the graph
        assert int((idx.graph.levels >= 0).sum()) == 64
        assert idx.stats()["pending_inserts"] == 192
        ids, _ = idx.search_batch(vecs[200:208], 1)
        assert (ids[:, 0] == np.arange(200, 208)).all()
        idx.flush_pending()
        assert idx.stats()["pending_inserts"] == 0
        assert int((idx.graph.levels >= 0).sum()) == 256
