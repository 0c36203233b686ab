"""The port's HNSW index (vector_db_torch/index/hnsw.py) against the
reference's, through the same sequence of calls on the same seeded rows.

Both packages draw the same levels (a numpy generator seeded alike), so the
graphs are held as in tests/test_torch_hnsw_graph.py: levels and entry point
equal, at least 99% of the adjacency rows equal as sets.  Searches: the same
ids for at least 99% of the answers, recall against an exact oracle no lower
than the reference's minus 0.005.  Matmuls run at full f32 precision on both
sides.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from vector_db_tpu.api.config import HnswConfig as RefConfig  # noqa: E402
from vector_db_tpu.index import hnsw as ref_hnsw  # noqa: E402
from vector_db_torch.api.config import HnswConfig  # noqa: E402
from vector_db_torch.index import hnsw  # noqa: E402

D, N, CAP, K, M = 32, 1500, 2048, 10, 8


@pytest.fixture(autouse=True)
def _full_f32_matmuls():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_float32_matmul_precision(before)


def _rows(n, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, D)) * r.uniform(0.5, 2.0, (n, 1))
            ).astype(np.float32)


def _pair(metric="l2", **kw):
    kw = dict(m=M, ef_construction=32, flush_min=64, **kw)
    return (ref_hnsw.HnswIndex(D, CAP, metric, RefConfig(**kw)),
            hnsw.HnswIndex(D, CAP, metric, HnswConfig(**kw), device="cpu"))


def _rows_equal(a, b):
    a = np.sort(np.asarray(a).reshape(-1, a.shape[-1]), axis=1)
    b = np.sort(np.asarray(b).reshape(-1, b.shape[-1]), axis=1)
    return float(np.mean(np.all(a == b, axis=1)))


def _same_graph(port, ref):
    g, r = port.graph, ref.graph
    np.testing.assert_array_equal(g.levels.numpy(), np.asarray(r.levels))
    assert (g.entry, g.entry_level) == (int(r.entry), int(r.entry_level))
    assert _rows_equal(g.neighbors.numpy(), r.neighbors) >= 0.99
    assert port._level_counter == ref._level_counter
    assert port._pending_count == ref._pending_count


def _recall(ids, rows, queries, metric):
    keys = np.asarray(sorted(rows))
    mat = np.stack([rows[i] for i in keys]).astype(np.float64)
    q = queries.astype(np.float64)
    if metric == "cosine":
        mat = mat / np.linalg.norm(mat, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    gt = keys[np.argsort(((q[:, None] - mat[None]) ** 2).sum(-1), 1)[:, :K]]
    return float(np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, gt)]))


def _same_answers(port, ref, queries, rows, metric="l2"):
    want_i, want_d = ref.search_batch(queries, K)
    got_i, got_d = port.search_batch(torch.from_numpy(queries), K)
    assert np.mean(got_i == want_i) >= 0.99
    same = got_i == want_i
    np.testing.assert_allclose(got_d[same], want_d[same], rtol=1e-4,
                               atol=1e-5)
    assert _recall(got_i, rows, queries, metric) \
        >= _recall(want_i, rows, queries, metric) - 0.005
    return got_i


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_hnsw_index_follows_the_reference(metric):
    """Bulk build on the first flush, adds answered through the pending
    overlay, the delta flush, delete of a pending row, of a graph row and of
    the entry point, and a rebuild."""
    ref, port = _pair(metric)
    base, queries = _rows(N, 71), _rows(16, 72)
    rows = dict(enumerate(base[:1000]))
    assert port.add_batch(range(1000), base[:1000]) \
        == ref.add_batch(range(1000), base[:1000])
    _same_graph(port, ref)                      # built by the first flush
    assert port.graph.entry >= 0 and port._pending_count == 0
    got = _same_answers(port, ref, queries, rows, metric)
    assert _recall(got, rows, queries, metric) >= 0.8

    # 120 adds stay pending (threshold max(64, 0.25 * 1000) = 250)
    ids = list(range(1000, 1120))
    assert port.add_batch(ids, base[1000:1120]) \
        == ref.add_batch(ids, base[1000:1120])
    rows.update(zip(ids, base[1000:1120]))
    assert port._pending_count == ref._pending_count == 120
    assert port.stats()["pending_inserts"] == 120
    _same_graph(port, ref)
    _same_answers(port, ref, queries, rows, metric)
    own, _ = port.search_batch(base[1000:1016], 1)   # found while pending
    np.testing.assert_array_equal(own[:, 0], ids[:16])

    # a pending row goes without touching the graph
    assert port.remove(1005) and ref.remove(1005)
    del rows[1005]
    assert port._pending_count == ref._pending_count == 119

    # 150 more cross the threshold: one delta flush connects all of them
    ids = list(range(1120, 1270))
    assert port.add_batch(ids, base[1120:1270]) \
        == ref.add_batch(ids, base[1120:1270])
    rows.update(zip(ids, base[1120:1270]))
    assert port._pending_count == ref._pending_count == 0
    _same_graph(port, ref)
    _same_answers(port, ref, queries, rows, metric)
    own, _ = port.search_batch(base[1120:1136], 1)   # reached in the graph
    assert np.mean(own[:, 0] == ids[:16]) >= 0.85

    # the entry point and a plain node are deleted
    entry_id = int(port.store.state.ids[port.graph.entry])
    for vid in (entry_id, 17):
        assert port.remove(vid) and ref.remove(vid)
        del rows[vid]
    assert not port.remove(entry_id)
    _same_graph(port, ref)
    got = _same_answers(port, ref, queries, rows, metric)
    assert entry_id not in got and 17 not in got

    port.build()
    ref.build()
    _same_graph(port, ref)
    _same_answers(port, ref, queries, rows, metric)
    s, rs = port.stats(), ref.stats()
    for key in ("size", "m", "max_level", "entry_point", "level_histogram",
                "pending_inserts"):
        assert s[key] == rs[key], key
    assert abs(s["avg_degree_l0"] - rs["avg_degree_l0"]) < 0.05


def test_stream_policy_inserts_at_once_like_the_reference():
    """insert_policy="stream" without the bulk build: the whole graph comes
    from insertion rounds.  The reference's connect scatters its masked
    targets through slot 0, and a fresh index seeds the graph at slot 0: the
    seed loses its reverse edges there and later beams start from a node
    without any, so the adjacency is not comparable (ops/hnsw_graph is held
    to the reference on slots from 1 in tests/test_torch_hnsw_graph.py).
    Here: equal levels and entry point, the port's recall at least the
    reference's, and every node linked."""
    ref, port = _pair(insert_policy="stream", bulk_build=False,
                      batch_insert=8)
    base, queries = _rows(96, 73), _rows(8, 74)
    for s in range(0, 96, 24):
        ids = list(range(s, s + 24))
        assert port.add_batch(ids, base[s:s + 24]) \
            == ref.add_batch(ids, base[s:s + 24])
        assert port._pending_count == 0
    g, r = port.graph, ref.graph
    np.testing.assert_array_equal(g.levels.numpy(), np.asarray(r.levels))
    assert (g.entry, g.entry_level) == (int(r.entry), int(r.entry_level))
    assert ((g.neighbors[0, :96] >= 0).sum(1) >= 2).all()
    ids, _ = port.search_batch(torch.from_numpy(queries), K)
    want_ids, _ = ref.search_batch(queries, K)
    rows = dict(enumerate(base))
    assert _recall(ids, rows, queries, "l2") \
        >= _recall(want_ids, rows, queries, "l2") - 0.005
    assert _recall(ids, rows, queries, "l2") >= 0.9


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_checkpoints_cross_both_ways(metric):
    ref, port = _pair(metric)
    base, queries = _rows(N, 75), _rows(16, 76)
    ref.add_batch(range(1000), base[:1000])
    port.add_batch(range(1000), base[:1000])
    ref.add_batch(range(1000, 1100), base[1000:1100])     # pending
    port.add_batch(range(1000, 1100), base[1000:1100])
    rows = dict(enumerate(base[:1100]))

    # reference -> port: the save connects the pending rows first
    state = ref.state_arrays()
    assert ref._pending_count == 0
    _, loaded = _pair(metric)
    loaded.load_state_arrays(state)
    _same_graph(loaded, ref)
    _same_answers(loaded, ref, queries, rows, metric)

    # port -> reference
    state = port.state_arrays()
    assert port._pending_count == 0
    assert set(state) == {"store", "graph", "level_counter"}
    assert set(state["graph"]) == {"neighbors", "levels", "entry",
                                   "entry_level"}
    back, _ = _pair(metric)
    back.load_state_arrays(state)
    _same_graph(port, back)
    _same_answers(port, back, queries, rows, metric)
    # and both go on alike from the loaded state
    ids = list(range(2000, 2100))
    assert loaded.add_batch(ids, base[1100:1200]) \
        == back.add_batch(ids, base[1100:1200])
    rows.update(zip(ids, base[1100:1200]))
    _same_answers(loaded, back, queries, rows, metric)


def test_small_and_empty_indexes_scan_exactly():
    _, port = _pair()
    base = _rows(40, 77)
    ids, d = port.search_batch(base[:2], 3)
    assert (ids == -1).all() and np.isinf(d).all()
    port.add_batch(range(5), base[:5])           # n_live <= k: exact scan
    ids, _ = port.search_batch(base[:5], K)
    np.testing.assert_array_equal(ids[:, 0], np.arange(5))
    assert (ids[:, 5:] == -1).all()
    with pytest.raises(ValueError, match="expected"):
        port.search_batch(np.zeros((2, D + 1), np.float32), 3)
    assert port.add_batch([3], base[:1]) == []   # duplicate id


def test_optimize_for_high_dimension_like_the_reference():
    ref = ref_hnsw.HnswIndex(1024, 128, "l2", RefConfig(m=8))
    port = hnsw.HnswIndex(1024, 128, "l2", HnswConfig(m=8), device="cpu")
    port.graph.neighbors[0, 3, :4] = torch.tensor([1, 2, 5, 7],
                                                  dtype=torch.int32)
    for idx in (ref, port):
        idx.optimize_for_high_dimension()
    for key in ("m", "ef_construction", "ef_search"):
        assert getattr(port.config, key) == getattr(ref.config, key)
    assert tuple(port.graph.neighbors.shape) == ref.graph.neighbors.shape
    assert port.graph.neighbors[0, 3].tolist() == [1, 2, 5, 7] + [-1] * 36


def test_config_policies_equal_the_references():
    for kw in (dict(), dict(ef_search=100), dict(max_level=5), dict(m=16)):
        a, b = HnswConfig(**kw), RefConfig(**kw)
        for cap in (128, 10_000, 1_000_000):
            assert a.derived_max_level(cap) == b.derived_max_level(cap)
        for k in (1, 10, 128):
            for n in (50, 1000, 5001, 20_001, 1_000_000):
                for dim in (0, 128, 256, 512, 1024):
                    assert a.ef_for_query(k, n, dim) \
                        == b.ef_for_query(k, n, dim)


def test_device_is_required():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        hnsw.HnswIndex(D, CAP)
