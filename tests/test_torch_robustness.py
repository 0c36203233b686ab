"""Robustness of the port (a copy of the reference's
``tests/test_robustness.py``) on the CPU: cosine across index types,
concurrent searches and readers racing writers, a dimension sweep, cosine
with varied norms through every quantized HNSWPQ mode and flat PQ, the
compressed tier under concurrency, and ``utils/locks.RWLock``.

Where the answer is exact (BRUTE, the flagship's exact scan at this size),
the same seeded inputs also go through ``vector_db_tpu`` and the two
packages must return the same ids.  The module caps torch's intra-op
threads (``_few_threads``): the cases are small, and under a parallel test
run extra threads only oversubscribe the cores; the concurrency cases make
their own threads.
"""

import concurrent.futures
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import vector_db_torch  # noqa: E402
import vector_db_tpu as ref_vdb  # noqa: E402
from vector_db_torch import (HnswPqConfig, IndexType,  # noqa: E402
                             VectorDatabase)
from vector_db_torch.api.config import PqConfig  # noqa: E402
from vector_db_torch.index.brute import BruteForceIndex  # noqa: E402
from vector_db_torch.index.hnsw_pq import HnswPqIndex  # noqa: E402
from vector_db_torch.index.pq import PqIndex  # noqa: E402
from vector_db_torch.utils.locks import RWLock  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _ids(rows):
    return [[r.id for r in row] for row in rows]


def _rows(rows):
    return [[(r.id, r.distance) for r in row] for row in rows]


class TestCosineMetric:
    @pytest.mark.parametrize("itype", ["BRUTE", "HNSWPQ"])
    def test_scale_invariance(self, rng, itype):
        """Cosine search ranks a scaled copy first, in both packages."""
        dim, n = 16, 300
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        q = 5.0 * vecs[17]  # scaled copy: cosine-identical to vector 17
        top = {}
        for pkg in (ref_vdb, vector_db_torch):
            b = (pkg.VectorDatabase.builder().with_dimension(dim)
                 .with_max_elements(512)
                 .with_index_type(getattr(pkg.IndexType, itype))
                 .with_metric("cosine"))
            if itype == "HNSWPQ":
                b = b.with_index_config(pkg.HnswPqConfig(
                    num_subspaces=4, num_centroids=16, training_samples=128))
            if pkg is not ref_vdb:
                b = b.with_device("cpu")
            db = b.build()
            db.add_batch(range(n), vecs)
            db.rebuild_index()
            top[pkg.__name__] = [r.id for r in db.search(q, 3)]
            db.close()
        assert top["vector_db_torch"][0] == 17
        assert top["vector_db_torch"] == top["vector_db_tpu"]


class TestConcurrentSearch:
    def test_parallel_searches_consistent(self, rng):
        """Many threads searching at once get the single-thread answer,
        which is the reference's."""
        dim, n = 16, 256
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        db = (VectorDatabase.builder().with_dimension(dim)
              .with_max_elements(512).with_index_type(IndexType.BRUTE)
              .with_device("cpu").build())
        db.add_batch(range(n), vecs)
        q = vecs[:8]
        want = _rows(db.search_batch(q, 5))

        def worker(_):
            return _rows(db.search_batch(q, 5))

        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            results = list(ex.map(worker, range(16)))
        assert all(r == want for r in results)
        ref = (ref_vdb.VectorDatabase.builder().with_dimension(dim)
               .with_max_elements(512)
               .with_index_type(ref_vdb.IndexType.BRUTE).build())
        ref.add_batch(range(n), vecs)
        assert _ids(ref.search_batch(q, 5)) == [[i for i, _ in row]
                                                for row in want]
        ref.close()
        db.close()

    def test_search_during_mutation(self, rng):
        """Searches interleaved with adds never crash and never return
        padding ids."""
        dim = 8
        db = (VectorDatabase.builder().with_dimension(dim)
              .with_max_elements(512).with_index_type(IndexType.BRUTE)
              .with_device("cpu").build())
        vecs = rng.standard_normal((200, dim)).astype(np.float32)
        db.add_batch(range(100), vecs[:100])

        def searcher(_):
            out = db.search_batch(vecs[:4], 3)
            return all(r.id >= 0 for row in out for r in row)

        def mutator(i):
            db.add_vector(100 + i, vecs[100 + i])
            return True

        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
            futs = [ex.submit(searcher, i) if i % 2 else ex.submit(mutator, i)
                    for i in range(40)]
            assert all(f.result() for f in futs)
        db.close()


class TestDimensionSweep:
    @pytest.mark.parametrize("dim", [24, 96, 384])
    def test_flagship_across_dims(self, rng, dim):
        n = 300
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        db = (VectorDatabase.builder().with_dimension(dim)
              .with_max_elements(512).with_index_type(IndexType.HNSWPQ)
              .with_index_config(HnswPqConfig(
                  num_subspaces=max(4, dim // 8), num_centroids=16,
                  training_samples=128))
              .with_device("cpu").build())
        db.add_batch(range(n), vecs)
        ids = [r.id for r in db.search(vecs[42], 1)]
        assert ids[0] == 42
        assert db.get_compression_ratio() >= 4.0
        db.close()


class TestConcurrentStress:
    """1/2/4/8-thread searches equal to the single-thread answer, and
    readers racing a writer (add_batch and rebuild_index)."""

    @pytest.mark.parametrize("threads", [1, 2, 4, 8])
    def test_thread_sweep_flagship(self, rng, threads):
        dim, n = 16, 400
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        db = (VectorDatabase.builder().with_dimension(dim)
              .with_max_elements(512).with_index_type(IndexType.HNSWPQ)
              .with_device("cpu").build())
        db.add_batch(range(n), vecs)
        q = vecs[:8]
        want = _rows(db.search_batch(q, 5))

        def worker(_):
            return _rows(db.search_batch(q, 5))

        with concurrent.futures.ThreadPoolExecutor(max_workers=threads) as ex:
            results = list(ex.map(worker, range(threads * 4)))
        assert all(r == want for r in results)
        ref = (ref_vdb.VectorDatabase.builder().with_dimension(dim)
               .with_max_elements(512)
               .with_index_type(ref_vdb.IndexType.HNSWPQ).build())
        ref.add_batch(range(n), vecs)
        assert _ids(ref.search_batch(q, 5)) == [[i for i, _ in row]
                                                for row in want]
        ref.close()
        db.close()

    def test_search_during_rebuild_and_batch_adds(self, rng):
        dim, n = 16, 300
        vecs = rng.standard_normal((2 * n, dim)).astype(np.float32)
        db = (VectorDatabase.builder().with_dimension(dim)
              .with_max_elements(1024).with_index_type(IndexType.HNSWPQ)
              .with_device("cpu").build())
        db.add_batch(range(n), vecs[:n])

        def searcher(_):
            ok = True
            for _ in range(10):
                rows = db.search_batch(vecs[:4], 3)
                for row in rows:
                    ok &= all(r.id >= 0 for r in row)
                    ok &= all(
                        row[j].distance <= row[j + 1].distance + 1e-5
                        for j in range(len(row) - 1))
            return ok

        def mutator(_):
            db.add_batch(range(n, n + 50), vecs[n:n + 50])
            db.rebuild_index()
            db.add_batch(range(n + 50, n + 100), vecs[n + 50:n + 100])
            db.rebuild_index()
            return True

        with concurrent.futures.ThreadPoolExecutor(max_workers=5) as ex:
            futs = [ex.submit(mutator, 0)] + [
                ex.submit(searcher, i) for i in range(4)]
            assert all(f.result() for f in futs)
        # post-race state is fully consistent
        ids = [r.id for r in db.search(vecs[n + 60], 1)]
        assert ids[0] == n + 60
        assert db.size() == n + 100
        db.close()


class TestCosineVariedNorms:
    """Cosine quantized indexes must rank by angle: PQ and PCA spaces hold
    the unit sphere, so rows of norms 0.1-10 do not bias the pools."""

    def _data(self):
        rng = np.random.default_rng(42)
        n, dim = 2048, 64
        scale = ((np.arange(dim) + 1.0) ** -0.5).astype(np.float32)
        vecs = (rng.standard_normal((n, dim)) * scale).astype(np.float32)
        vecs *= rng.uniform(0.1, 10.0, (n, 1)).astype(np.float32)
        return vecs

    def _recall(self, idx, vecs):
        n, dim = vecs.shape
        brute = BruteForceIndex(dim, n, "cosine", device="cpu")
        brute.add_batch(range(n), vecs)
        a, _ = idx.search_batch(vecs[:32], 10)
        g, _ = brute.search_batch(vecs[:32], 10)
        return np.mean([len(set(a[i]) & set(g[i])) / 10 for i in range(32)])

    @pytest.mark.parametrize("mode,extra", [
        ("adc_fast", dict(adc_bucket=8, adc_winners=2)),
        ("adc", {}),
        ("adc", dict(nlist=16, nprobe=6)),  # IVF-pruned probe selection
        ("graph", dict(use_graph=True)),
        ("pca", dict(proxy_dims=16, pca_r=128)),
    ])
    def test_hnswpq_modes(self, mode, extra):
        vecs = self._data()
        n, dim = vecs.shape
        cfg = HnswPqConfig(num_subspaces=8, training_samples=1024,
                           search_mode=mode, **extra)
        idx = HnswPqIndex(dim, n, "cosine", cfg, device="cpu")
        idx.add_batch(range(n), vecs)
        rec = self._recall(idx, vecs)
        assert rec >= 0.9, (mode, rec)

    def test_flat_pq(self):
        vecs = self._data()
        n, dim = vecs.shape
        idx = PqIndex(dim, n, "cosine", PqConfig(num_subspaces=8),
                      device="cpu")
        idx.add_batch(range(n), vecs)
        idx.build()
        rec = self._recall(idx, vecs)
        assert rec >= 0.9, rec


class TestConcurrentCompressedTier:
    """The compressed + residual tier's shadows and tables are refreshed
    lazily at search time: searches interleaved with adds stay consistent
    (readers see the old or the new cache, never a torn one)."""

    def test_search_during_mutation_residual(self, rng):
        dim, n = 16, 512
        cfg = HnswPqConfig(raw_store=False, refine_residual=True,
                           num_subspaces=4, num_centroids=16,
                           training_samples=64,
                           search_mode="scan_pallas_int8")
        db = (VectorDatabase.builder().with_dimension(dim)
              .with_max_elements(1024).with_index_type(IndexType.HNSWPQ)
              .with_index_config(cfg).with_device("cpu").build())
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        db.add_batch(range(256), vecs[:256])
        db.search_batch(vecs[:4], 3)  # warm caches

        def searcher(_):
            out = db.search_batch(vecs[:4], 3)
            return all(r.id >= 0 for row in out for r in row)

        def mutator(i):
            db.add_vector(256 + i, vecs[256 + i])
            return True

        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
            futs = [ex.submit(searcher, i) if i % 2 else ex.submit(mutator, i)
                    for i in range(40)]
            assert all(f.result() for f in futs)
        # everything that was added is findable afterwards
        added = 256 + np.arange(0, 40, 2)
        out = db.search_batch(vecs[added], 1)
        assert [row[0].id for row in out] == added.tolist()
        db.close()


class TestRWLock:
    """``utils/locks.RWLock``: concurrent readers, an exclusive writer, and
    writer preference (no writer starves under a stream of readers)."""

    def test_concurrent_readers(self):
        lock = RWLock()
        active = []
        peak = []

        def reader():
            with lock.read():
                active.append(1)
                peak.append(len(active))
                time.sleep(0.02)
                active.pop()

        ts = [threading.Thread(target=reader) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        assert max(peak) > 1, "readers never overlapped"

    def test_writer_excludes_and_is_preferred(self):
        lock = RWLock()
        order = []

        def long_reader():
            with lock.read():
                order.append("r1-in")
                time.sleep(0.05)
            order.append("r1-out")

        def writer():
            with lock.write():
                order.append("w")

        def late_reader():
            with lock.read():
                order.append("r2")

        t1 = threading.Thread(target=long_reader)
        t1.start()
        time.sleep(0.01)  # writer arrives while r1 holds the lock
        tw = threading.Thread(target=writer)
        tw.start()
        time.sleep(0.01)  # a reader arriving AFTER a waiting writer queues
        t2 = threading.Thread(target=late_reader)
        t2.start()
        for t in (t1, tw, t2):
            t.join(timeout=30)
        assert not any(t.is_alive() for t in (t1, tw, t2))
        # writer preference: w runs before the late reader
        assert order.index("w") < order.index("r2"), order
        assert order.index("r1-out") < order.index("w"), order
