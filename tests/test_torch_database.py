"""The port's VectorDatabase facade (vector_db_torch/api/database.py):
copies of the reference's CRUD and persistence cases for all seven index
types, the factory's routing and default configurations against the
reference's, churn cycles, checkpoints written by the reference loading
into the port, and the package's independence from JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import vector_db_tpu as ref_vdb  # noqa: E402
from vector_db_torch import (AnnoyConfig, CompressionConfig,  # noqa: E402
                             HnswConfig, HnswPqConfig, IndexType, IvfConfig,
                             LshConfig, PqConfig, SearchResult,
                             VectorDatabase)

KINDS = list(IndexType)


def make_db(kind, path=None, dim=10, max_elements=1000):
    b = (VectorDatabase.builder().with_dimension(dim)
         .with_max_elements(max_elements).with_index_type(kind)
         .with_device("cpu"))
    if kind is IndexType.HNSWPQ:
        b = b.with_index_config(HnswPqConfig(num_subspaces=2))
    if path:
        b = b.with_storage_path(path)
    return b.build()


@pytest.mark.parametrize("kind", KINDS)
class TestCrud:
    def test_add_and_retrieve(self, kind, rng):
        db = make_db(kind)
        v = rng.standard_normal(10).astype(np.float32)
        assert db.add_vector(7, v)
        got = db.get_vector(7)
        assert got is not None and got.id == 7
        np.testing.assert_allclose(got.values, v, rtol=1e-6)
        assert db.size() == 1

    def test_duplicate_add_rejected(self, kind):
        db = make_db(kind)
        assert db.add_vector(1, np.ones(10))
        assert not db.add_vector(1, np.zeros(10))

    def test_dim_mismatch_rejected(self, kind):
        db = make_db(kind)
        assert not db.add_vector(1, np.ones(11))
        with pytest.raises(ValueError):
            db.search(np.ones(11, np.float32), 3)

    def test_deleted_vector_not_searchable(self, kind, rng):
        db = make_db(kind)
        target = np.ones(10, np.float32)
        db.add_vector(1, target)
        db.add_batch(range(2, 400), rng.standard_normal((398, 10)))
        assert db.delete_vector(1)
        assert db.get_vector(1) is None and not db.delete_vector(1)
        assert 1 not in [r.id for r in db.search(target, 5)]

    def test_k_larger_than_size(self, kind, rng):
        db = make_db(kind)
        db.add_batch(range(5), rng.standard_normal((5, 10)))
        res = db.search(rng.standard_normal(10).astype(np.float32), 20)
        assert sorted(r.id for r in res) == list(range(5))
        assert [r.distance for r in res] == sorted(r.distance for r in res)

    def test_search_batch_finds_each_row(self, kind, rng):
        db = make_db(kind)
        vecs = rng.standard_normal((600, 10)).astype(np.float32)
        db.add_batch(range(600), vecs)
        res = db.search_batch(torch.from_numpy(vecs[:8]), 1)
        assert [r[0].id for r in res] == list(range(8))

    def test_use_after_close_raises(self, kind, tmp_store_path):
        db = make_db(kind, tmp_store_path)
        db.close()
        with pytest.raises(RuntimeError):
            db.size()

    def test_close_and_reopen(self, kind, rng, tmp_store_path):
        vecs = rng.standard_normal((500, 10)).astype(np.float32)
        db = make_db(kind, tmp_store_path)
        db.add_batch(range(500), vecs)
        db.delete_vector(3)
        before = [[r.id for r in row] for row in db.search_batch(vecs[:16], 5)]
        db.close()
        db2 = make_db(kind, tmp_store_path)
        assert db2.size() == 499 and db2.get_vector(3) is None
        np.testing.assert_allclose(db2.get_vector(4).values, vecs[4])
        after = [[r.id for r in row] for row in db2.search_batch(vecs[:16], 5)]
        assert after == before


def test_wal_replays_mutations_after_the_checkpoint(rng, tmp_store_path):
    """Adds and deletes after the last checkpoint survive a crash (no
    close) through the write-ahead log."""
    vecs = rng.standard_normal((300, 10)).astype(np.float32)
    db = make_db(IndexType.HNSWPQ, tmp_store_path)
    db.add_batch(range(300), vecs)
    db.save()
    db.add_vector(1000, np.full(10, 5.0, np.float32))
    db.delete_vector(7)
    db._engine.close()  # the process dies without close()
    db2 = make_db(IndexType.HNSWPQ, tmp_store_path)
    assert db2.size() == 300 and db2.get_vector(7) is None
    assert db2.search(np.full(10, 5.0, np.float32), 1)[0].id == 1000


def test_reference_checkpoint_loads_with_same_answers(rng, tmp_store_path):
    vecs = rng.standard_normal((1500, 16)).astype(np.float32)
    queries = rng.standard_normal((24, 16)).astype(np.float32)
    ref = (ref_vdb.VectorDatabase.builder().with_dimension(16)
           .with_max_elements(2000).with_index_type(ref_vdb.IndexType.HNSWPQ)
           .with_index_config(ref_vdb.HnswPqConfig(num_subspaces=4))
           .with_storage_path(tmp_store_path).build())
    ref.add_batch(range(1500), vecs)
    for vid in range(0, 1500, 7):
        ref.delete_vector(vid)
    want = [[r.id for r in row] for row in ref.search_batch(queries, 10)]
    ref_size = ref.size()
    ref.close()
    port = (VectorDatabase.builder().with_dimension(16).with_max_elements(2000)
            .with_index_type(IndexType.HNSWPQ)
            .with_index_config(HnswPqConfig(num_subspaces=4))
            .with_storage_path(tmp_store_path).with_device("cpu").build())
    assert port.size() == ref_size and port.index.trained
    got = [[r.id for r in row] for row in port.search_batch(queries, 10)]
    assert got == want


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        VectorDatabase.builder().with_dimension(4).with_max_elements(8) \
            .with_index_type(IndexType.BRUTE).build()


def test_reference_hnsw_checkpoint_loads_with_same_answers(rng,
                                                           tmp_store_path):
    """IndexType.HNSW through both facades: the reference's checkpoint
    (graph included, pending rows connected by the save) answers alike in
    the port, which then goes on adding and deleting."""
    vecs = rng.standard_normal((1400, 16)).astype(np.float32)
    queries = rng.standard_normal((24, 16)).astype(np.float32)
    ref = (ref_vdb.VectorDatabase.builder().with_dimension(16)
           .with_max_elements(2000).with_index_type(ref_vdb.IndexType.HNSW)
           .with_index_config(ref_vdb.HnswConfig(m=8, ef_search=64))
           .with_storage_path(tmp_store_path).build())
    ref.add_batch(range(1200), vecs[:1200])
    for vid in range(0, 1200, 7):
        ref.delete_vector(vid)
    ref.close()
    ref = (ref_vdb.VectorDatabase.builder().with_dimension(16)
           .with_max_elements(2000).with_index_type(ref_vdb.IndexType.HNSW)
           .with_index_config(ref_vdb.HnswConfig(m=8, ef_search=64))
           .with_storage_path(tmp_store_path).build())
    want = [[r.id for r in row] for row in ref.search_batch(queries, 10)]
    port = (VectorDatabase.builder().with_dimension(16).with_max_elements(2000)
            .with_index_type(IndexType.HNSW)
            .with_index_config(HnswConfig(m=8, ef_search=64))
            .with_storage_path(tmp_store_path).with_device("cpu").build())
    assert port.index.kind == "hnsw" and port.size() == ref.size()
    assert port.index.graph.entry == int(ref.index.graph.entry) >= 0
    got = [[r.id for r in row] for row in port.search_batch(queries, 10)]
    assert np.mean(np.asarray(got) == np.asarray(want)) >= 0.99
    port.add_batch(range(5000, 5200), vecs[1200:])
    assert port.stats()["pending_inserts"] == 200
    assert port.search(vecs[1250], 1)[0].id == 5050
    assert port.delete_vector(5050)
    assert port.search(vecs[1250], 1)[0].id != 5050
    port.close()


def test_hnsw_with_compression_routes_to_hnswpq():
    db = (VectorDatabase.builder().with_dimension(16).with_max_elements(256)
          .with_index_type(IndexType.HNSW).with_device("cpu")
          .with_compression(CompressionConfig.hnsw_pq_config(4)).build())
    assert db.index.kind == "hnswpq" and db.index.config.num_subspaces == 4
    plain = (VectorDatabase.builder().with_dimension(16)
             .with_max_elements(256).with_index_type("hnsw")
             .with_device("cpu").build())
    assert plain.index.kind == "hnsw" and plain.index.config.m == 32


@pytest.mark.parametrize("kind", KINDS)
def test_index_types_route_with_the_reference_defaults(kind):
    """Each type builds the reference's index kind with a default
    configuration equal to the reference's."""
    port = (VectorDatabase.builder().with_dimension(24)
            .with_max_elements(256).with_index_type(kind)
            .with_device("cpu").build())
    ref = (ref_vdb.VectorDatabase.builder().with_dimension(24)
           .with_max_elements(256).with_index_type(kind.value).build())
    assert port.index.kind == ref.index.kind == kind.value
    if kind is not IndexType.BRUTE:
        assert dataclasses.asdict(port.index.config) == \
            dataclasses.asdict(ref.index.config)


def test_pq_compression_routes_to_pq_with_effective_subspaces():
    for kind in (IndexType.PQ, IndexType.HNSW):
        db = (VectorDatabase.builder().with_dimension(24)
              .with_max_elements(256).with_index_type(kind)
              .with_compression(CompressionConfig.pq_config(16))
              .with_device("cpu").build())
        assert db.index.kind == "pq"
        assert db.index.config.num_subspaces == \
            CompressionConfig.pq_config(16).effective_subspaces(24) == 12


CHURN = [
    (IndexType.PQ, PqConfig(num_subspaces=4, num_centroids=16)),
    (IndexType.IVF, IvfConfig(num_clusters=8, num_probes=8)),
    (IndexType.LSH, LshConfig(num_tables=6, num_bits=8)),
    (IndexType.ANNOY, AnnoyConfig(num_trees=4, leaf_size=8)),
]


@pytest.mark.parametrize("kind,cfg", CHURN, ids=[c[0].value for c in CHURN])
def test_churn_cycles(kind, cfg):
    """tests/test_churn.py's cycles (add a wave, delete a third of the
    oldest, rebuild every other cycle) on the port."""
    dim = 12
    db = (VectorDatabase.builder().with_dimension(dim).with_max_elements(512)
          .with_index_type(kind).with_index_config(cfg).with_device("cpu")
          .build())
    live: dict[int, np.ndarray] = {}
    next_id = 0
    r = np.random.default_rng(42)
    for cycle in range(4):
        vecs = r.standard_normal((60, dim)).astype(np.float32)
        ids = list(range(next_id, next_id + 60))
        assert len(db.add_batch(ids, vecs)) == 60
        live.update(zip(ids, vecs))
        next_id += 60
        victims = sorted(live)[:20]
        for v in victims:
            assert db.delete_vector(v)
            del live[v]
        if cycle % 2 == 1:
            db.rebuild_index()
        assert db.size() == len(live)
        for vid, vec in list(live.items())[:10]:
            np.testing.assert_allclose(db.get_vector(vid).values, vec,
                                       rtol=1e-6)
            res = [x.id for x in db.search(vec, 5)]
            assert res and all(i in live for i in res)
        for v in victims[:5]:
            assert db.get_vector(v) is None
    db.close()


REF_CONFIGS = {
    IndexType.PQ: ("PqConfig", dict(num_subspaces=4)),
    IndexType.IVF: ("IvfConfig", dict(num_clusters=16, num_probes=4)),
    IndexType.LSH: ("LshConfig", {}),
    IndexType.ANNOY: ("AnnoyConfig", dict(num_trees=4, leaf_size=8)),
}


@pytest.mark.parametrize("kind", list(REF_CONFIGS), ids=lambda k: k.value)
def test_reference_checkpoint_of_each_new_type_opens(kind, rng,
                                                     tmp_store_path):
    """A database the reference built, rebuilt, trimmed and closed opens
    in the port's facade with the same size and answers."""
    vecs = rng.standard_normal((1200, 16)).astype(np.float32)
    queries = rng.standard_normal((16, 16)).astype(np.float32)
    name, cfg = REF_CONFIGS[kind]
    ref = (ref_vdb.VectorDatabase.builder().with_dimension(16)
           .with_max_elements(2000).with_index_type(kind.value)
           .with_index_config(getattr(ref_vdb, name)(**cfg))
           .with_storage_path(tmp_store_path).build())
    ref.add_batch(range(1200), vecs)
    ref.rebuild_index()
    for vid in range(0, 1200, 9):
        ref.delete_vector(vid)
    want = [[r.id for r in row] for row in ref.search_batch(queries, 10)]
    ref.close()
    port_cfg = {IndexType.PQ: PqConfig, IndexType.IVF: IvfConfig,
                IndexType.LSH: LshConfig, IndexType.ANNOY: AnnoyConfig}[kind]
    port = (VectorDatabase.builder().with_dimension(16)
            .with_max_elements(2000).with_index_type(kind)
            .with_index_config(port_cfg(**cfg))
            .with_storage_path(tmp_store_path).with_device("cpu").build())
    assert port.index.kind == kind.value and port.size() == 1200 - 134
    got = [[r.id for r in row] for row in port.search_batch(queries, 10)]
    assert np.mean(np.asarray(got) == np.asarray(want)) >= 0.99
    port.close()


def test_similarity_formula():
    assert SearchResult(1, 2.0).similarity == pytest.approx(0.5)


def test_package_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import vector_db_torch\n"
        "for m in pkgutil.walk_packages(vector_db_torch.__path__,"
        " 'vector_db_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'vector_db_tpu'))\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
