"""The reference's benchmark acceptance suite (``tests/test_benchmark_parity.py``:
RecallOptimizationTest, RecallDiagnosticTest and a scaled
CompressionPerformanceTest matrix) on the port, on the CPU.

The same seeds, sizes and floors: Recall@10 >= 0.70 and >= 0.85 in ``adc``
mode, >= 0.97 under auto, the trained flag, every row finding itself, and
the compressed-vs-uncompressed matrix >= 0.8 at a ratio >= 4.  Each recall
case also runs ``vector_db_tpu`` on the same data: the port, trained on its
own, meets the floors, and where PQ training draws differently (the port's
k-means++ seeds are not JAX's) the port loaded with the reference's trained
state (``load_state_arrays(state_arrays())``) reaches at least the
reference's recall.  The full-size configuration runs in
``python -m vector_db_torch.bench``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import vector_db_tpu as ref_vdb  # noqa: E402
from vector_db_tpu.index.brute import BruteForceIndex as RefBrute  # noqa: E402
from vector_db_tpu.index.hnsw_pq import HnswPqIndex as RefHnswPq  # noqa: E402
from vector_db_torch import (CompressionConfig, HnswPqConfig,  # noqa: E402
                             IndexType, VectorDatabase)
from vector_db_torch.index.brute import BruteForceIndex  # noqa: E402
from vector_db_torch.index.hnsw_pq import HnswPqIndex  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def brute_gt(vecs, queries, k):
    idx = BruteForceIndex(vecs.shape[1], vecs.shape[0], device=CPU)
    idx.add_batch(range(len(vecs)), vecs)
    ids, _ = idx.search_batch(queries, k)
    ref = RefBrute(vecs.shape[1], vecs.shape[0])
    ref.add_batch(range(len(vecs)), vecs)
    ref_ids, _ = ref.search_batch(queries, k)
    gt = [set(ids[i].tolist()) for i in range(len(queries))]
    assert gt == [set(ref_ids[i].tolist()) for i in range(len(queries))]
    return gt


def recall(pred_ids, gt_sets, k):
    return float(np.mean(
        [len(set(pred_ids[i].tolist()) & gt_sets[i]) / k
         for i in range(len(gt_sets))]
    ))


def hnswpq_pair(dim, cap, cfg_fields):
    """(port index on the CPU, reference index) of the same config."""
    return (HnswPqIndex(dim, cap, "l2", HnswPqConfig(**cfg_fields),
                        device=CPU),
            RefHnswPq(dim, cap, "l2", ref_vdb.HnswPqConfig(**cfg_fields)))


class TestRecallOptimization:
    """reference: benchmark/RecallOptimizationTest.java — brute-force GT
    computed in-test (:152-164), Recall@10 floors >=70% and >=85% (:204-205),
    config assertions (:66-70).  Scaled: 64d x 2000, 50 queries."""

    N, DIM, NQ, K = 2000, 64, 50, 10

    @pytest.fixture(scope="class")
    def dataset(self):
        rng = np.random.default_rng(42)
        vecs = rng.standard_normal((self.N, self.DIM)).astype(np.float32)
        queries = rng.standard_normal((self.NQ, self.DIM)).astype(np.float32)
        return vecs, queries, brute_gt(vecs, queries, self.K)

    def test_config_assertions(self):
        # reference :66-70 — subspace dim >= 4, ratio within [4x, 64x]
        cfg = CompressionConfig.recommended_config(self.DIM)
        sub = cfg.effective_subspaces(self.DIM)
        assert self.DIM // sub >= 4
        assert 4.0 <= cfg.compression_ratio(self.DIM) <= 64.0
        ref = ref_vdb.CompressionConfig.recommended_config(self.DIM)
        assert sub == ref.effective_subspaces(self.DIM)
        assert cfg.compression_ratio(self.DIM) == ref.compression_ratio(
            self.DIM)

    def test_flagship_memory_mode_recall_floor(self, dataset):
        vecs, queries, gt = dataset
        fields = dict(num_subspaces=self.DIM // 8, num_centroids=256,
                      training_iterations=10, training_samples=self.N,
                      refine_k=256, use_graph=False, search_mode="adc")
        idx, ref = hnswpq_pair(self.DIM, self.N, fields)
        for index in (idx, ref):
            index.add_batch(range(self.N), vecs)
            index.build()
            assert index.trained
        r = recall(idx.search_batch(queries, self.K)[0], gt, self.K)
        assert r >= 0.70, f"hard floor: {r:.2%}"
        assert r >= 0.85, f"target floor: {r:.2%}"
        r_ref = recall(ref.search_batch(queries, self.K)[0], gt, self.K)
        carried = HnswPqIndex(self.DIM, self.N, "l2",
                              HnswPqConfig(**fields), device=CPU)
        carried.load_state_arrays(ref.state_arrays())
        r_carried = recall(carried.search_batch(queries, self.K)[0], gt,
                           self.K)
        assert r_carried >= r_ref >= 0.85

    def test_flagship_auto_mode_recall(self, dataset):
        vecs, queries, gt = dataset
        idx, ref = hnswpq_pair(self.DIM, self.N, dict(
            num_subspaces=self.DIM // 8, training_samples=self.N))
        rs = []
        for index in (idx, ref):
            index.add_batch(range(self.N), vecs)
            rs.append(recall(index.search_batch(queries, self.K)[0], gt,
                             self.K))
        assert rs[0] >= 0.97
        assert rs[0] >= rs[1]


class TestRecallDiagnostic:
    """reference: benchmark/RecallDiagnosticTest.java — trained-flag check,
    self-retrieval on a 100-vector fixed-seed dataset (:207-257)."""

    def test_trained_flag_lifecycle(self):
        rng = np.random.default_rng(42)
        cfg = HnswPqConfig(num_subspaces=4, num_centroids=16,
                           training_samples=64, search_mode="adc", refine_k=64)
        idx = HnswPqIndex(16, 256, "l2", cfg, device=CPU)
        assert not idx.trained
        idx.add_batch(range(100), rng.standard_normal((100, 16)).astype(np.float32))
        assert idx.trained  # crossed the lazy-training threshold

    def test_find_yourself(self):
        # "find yourself": every DB vector's own query returns itself first
        rng = np.random.default_rng(42)
        vecs = rng.standard_normal((100, 16)).astype(np.float32)
        idx, ref = hnswpq_pair(16, 128, dict(
            num_subspaces=4, num_centroids=16, training_samples=64,
            refine_k=64, search_mode="adc"))
        for index in (idx, ref):
            index.add_batch(range(100), vecs)
            ids, _ = index.search_batch(vecs, 1)
            assert (ids[:, 0] == np.arange(100)).all()


def hnswpq_db(package, dim, n, fields, **kw):
    b = (package.VectorDatabase.builder().with_dimension(dim)
         .with_max_elements(n).with_index_type(package.IndexType.HNSWPQ)
         .with_index_config(package.HnswPqConfig(**fields)))
    return (b.with_device(CPU) if package is not ref_vdb else b).build()


class TestCompressionPerformanceMatrix:
    """reference: benchmark/CompressionPerformanceTest.java — compressed vs
    uncompressed across dims/K, recall measured against uncompressed results
    (:272-295).  Scaled to a smoke matrix."""

    @pytest.mark.parametrize("dim", [32, 64])
    @pytest.mark.parametrize("k", [1, 10])
    def test_compressed_vs_uncompressed(self, dim, k):
        import vector_db_torch

        rng = np.random.default_rng(42)
        n, nq = 600, 20
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        queries = vecs[:nq] + 0.05 * rng.standard_normal((nq, dim)).astype(np.float32)

        un = (VectorDatabase.builder().with_dimension(dim).with_max_elements(n)
              .with_index_type(IndexType.BRUTE).with_device(CPU).build())
        un.add_batch(range(n), vecs)
        gt = [{r.id for r in row} for row in un.search_batch(queries, k)]

        def rec(db):
            res = db.search_batch(queries, k)
            return np.mean([len({x.id for x in res[i]} & gt[i]) / k
                            for i in range(nq)])

        fields = dict(num_subspaces=max(4, dim // 8), num_centroids=64,
                      training_samples=n, refine_k=128, search_mode="adc")
        comp = hnswpq_db(vector_db_torch, dim, n, fields)
        ref = hnswpq_db(ref_vdb, dim, n, fields)
        for db in (comp, ref):
            db.add_batch(range(n), vecs)
        r = rec(comp)
        assert r >= 0.8
        assert comp.get_compression_ratio() >= 4.0
        assert comp.get_compression_ratio() == ref.get_compression_ratio()
        carried = hnswpq_db(vector_db_torch, dim, n, fields)
        carried.index.load_state_arrays(ref.index.state_arrays())
        assert rec(carried) >= rec(ref) >= 0.8
        for db in (un, comp, ref, carried):
            db.close()
