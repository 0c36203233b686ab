"""The port's HNSW+PQ index (vector_db_torch/index/hnsw_pq.py) against the
reference's, from the same trained state.

A reference index is trained once; its ``state_arrays()`` is loaded into
both packages, which then search, take the same removes and adds, and
search again.  Thresholds: mean top-10 overlap with the reference >= 0.99,
and recall against an exact numpy oracle no lower than the reference's
minus 0.005.  The reference runs its Pallas kernel in interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from vector_db_tpu.api.config import HnswPqConfig as RefConfig  # noqa: E402
from vector_db_tpu.index import hnsw_pq as ref_hp  # noqa: E402
from vector_db_torch.api.config import HnswPqConfig  # noqa: E402
from vector_db_torch.index import hnsw_pq as hp  # noqa: E402

D, N, CAP, K = 32, 3000, 4096, 10


@pytest.fixture(scope="module")
def trained():
    """(reference state_arrays of a trained index, corpus, queries)."""
    r = np.random.default_rng(11)
    base = (r.standard_normal((N, D)) + 1.0).astype(np.float32)
    queries = (r.standard_normal((32, D)) + 1.0).astype(np.float32)
    ref = ref_hp.HnswPqIndex(D, CAP, "l2",
                             RefConfig(num_subspaces=8, training_samples=2000))
    ref.add_batch(range(N), base)
    assert ref.trained
    return ref.state_arrays(), base, queries, r


def _pair(arrays, mode):
    ref = ref_hp.HnswPqIndex(D, CAP, "l2", RefConfig(num_subspaces=8,
                                                     search_mode=mode))
    ref.load_state_arrays(arrays)
    port = hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(num_subspaces=8,
                                                     search_mode=mode),
                          device="cpu")
    port.load_state_arrays(arrays)
    return ref, port


def _oracle(rows: dict, queries):
    ids = np.asarray(sorted(rows))
    mat = np.stack([rows[i] for i in ids]).astype(np.float64)
    d = ((queries[:, None, :].astype(np.float64) - mat[None]) ** 2).sum(-1)
    return ids[np.argsort(d, axis=1)[:, :K]]


def _overlap(a, b):
    return float(np.mean([len(set(x) & set(y)) / K for x, y in zip(a, b)]))


def _compare(ref, port, queries, rows):
    ref_ids, _ = ref.search_batch(queries, K)
    port_ids, port_d = port.search_batch(torch.from_numpy(queries), K)
    gt = _oracle(rows, queries)
    assert _overlap(port_ids, ref_ids) >= 0.99
    assert _overlap(port_ids, gt) >= _overlap(ref_ids, gt) - 0.005
    assert np.all(np.diff(port_d, axis=1) >= 0)


@pytest.mark.parametrize("mode", ["scan_exact", "scan_pallas_int8"])
def test_slice_matches_reference_before_and_after_churn(trained, mode):
    arrays, base, queries, _ = trained
    ref, port = _pair(arrays, mode)
    np.testing.assert_array_equal(port.codes.numpy(), arrays["codes"])
    rows = {i: base[i] for i in range(N)}
    _compare(ref, port, queries, rows)
    r = np.random.default_rng(21)
    for vid in r.choice(N, 200, replace=False).tolist():
        assert port.remove(vid) == ref.remove(vid)
        del rows[vid]
    new = (r.standard_normal((150, D)) + 1.0).astype(np.float32)
    new_ids = list(range(10_000, 10_150))
    assert port.add_batch(new_ids, new) == ref.add_batch(new_ids, new)
    rows.update(zip(new_ids, new))
    # the same codebooks encode the new rows to the same codes
    np.testing.assert_array_equal(port.codes.numpy(),
                                  np.asarray(ref.state_arrays()["codes"]))
    _compare(ref, port, queries, rows)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_scan8_shadow_matches_reference(metric):
    r = np.random.default_rng(12)
    vecs = (r.standard_normal((3000, D)) + 1.0).astype(np.float32)
    valid = r.uniform(size=3000) > 0.2
    norms = (vecs * vecs).sum(1)
    want = [np.asarray(x) for x in ref_hp._build_scan8_shadow(
        jnp.asarray(vecs), jnp.asarray(norms), jnp.asarray(valid), metric,
        2048)]
    got = [x.numpy() for x in hp._build_scan8_shadow(
        torch.from_numpy(vecs), torch.from_numpy(norms),
        torch.from_numpy(valid), metric, 2048)]
    base8, off, sc, cvec, aux = got
    assert base8.shape == want[0].shape == (4096, D)
    diff = np.abs(base8.astype(np.int32) - want[0].astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_array_equal(np.isfinite(off), np.isfinite(want[1]))
    fin = np.isfinite(off)
    np.testing.assert_allclose(off[fin], want[1][fin], rtol=1e-5)
    np.testing.assert_allclose(sc, want[2], rtol=1e-5)
    np.testing.assert_allclose(cvec, want[3], rtol=1e-5)
    np.testing.assert_allclose(aux, want[4], rtol=1e-5)


def test_scan8_shadow_pads_columns_to_words():
    vecs = torch.randn(300, 30, generator=torch.Generator().manual_seed(0))
    base8, *_ = hp._build_scan8_shadow(vecs, (vecs * vecs).sum(1),
                                       torch.ones(300, dtype=torch.bool),
                                       "l2", 2048)
    assert tuple(base8.shape) == (2048, 32)
    assert (base8[:, 30:] == 0).all()


def test_auto_picks_the_reference_mode(trained):
    for n in (0, 1, 99_999, 699_999, 700_000, 1_000_000, 10_000_000):
        for graph in (False, True):
            assert hp._auto_scan_mode(graph, n) == ref_hp._auto_scan_mode(
                graph, n)
    arrays, _, queries, _ = trained
    _, auto = _pair(arrays, "auto")
    _, exact = _pair(arrays, "scan_exact")
    q = torch.from_numpy(queries)
    np.testing.assert_array_equal(auto.search_batch(q, K)[0],
                                  exact.search_batch(q, K)[0])


def test_no_graph_is_allocated_without_use_graph():
    port = hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(num_subspaces=8),
                          device="cpu")
    ref = ref_hp.HnswPqIndex(D, CAP, "l2", RefConfig(num_subspaces=8))
    graph_bytes = int(np.prod(ref.graph.neighbors.shape)) * 4
    assert graph_bytes > 0 and not hasattr(port, "graph")
    held = [v for v in vars(port).values() if isinstance(v, torch.Tensor)]
    held += list(vars(port.store.state).values())
    st = port.store.state
    expected = (st.vectors.nbytes + st.ids.nbytes + st.norms.nbytes
                + st.valid.nbytes + port.codes.nbytes)
    assert sum(t.nbytes for t in held) == expected
    assert port.stats()["index_bytes"] == CAP * 8 and not port.stats()["use_graph"]
    # under use_graph=True it is the reference's [L, cap, M] int32 array
    port = hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(num_subspaces=8,
                                                     use_graph=True),
                          device="cpu")
    assert tuple(port.graph.neighbors.shape) == ref.graph.neighbors.shape
    assert port.graph.neighbors.nbytes == graph_bytes
    assert port.stats()["index_bytes"] == CAP * 8 + graph_bytes


def test_lazy_training_and_exact_fallback():
    r = np.random.default_rng(13)
    x = r.standard_normal((600, D)).astype(np.float32)
    idx = hp.HnswPqIndex(D, 2000, "l2", HnswPqConfig(num_subspaces=8),
                         device="cpu")
    idx.add_batch(range(100), x[:100])
    assert not idx.trained  # below max(threshold, num_centroids)
    ids, _ = idx.search_batch(x[:4], 3)
    np.testing.assert_array_equal(ids[:, 0], np.arange(4))
    idx.add_batch(range(100, 600), x[100:])
    assert idx.trained and idx.codebooks.shape == (8, 256, 4)
    ids, _ = idx.search_batch(x[:4], 3)
    np.testing.assert_array_equal(ids[:, 0], np.arange(4))
    for mode in ("pca", "adc", "graph"):
        hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(search_mode=mode),
                       device="cpu")


# ------------------------------------------------------------- graph mode
GRAPH_CFG = dict(num_subspaces=8, training_samples=2000, use_graph=True, m=8,
                 ef_construction=32, ef_search=32, refine_k=32, flush_min=64,
                 flush_frac=0.1)


def _rows_equal(a, b):
    a = np.sort(np.asarray(a).reshape(-1, a.shape[-1]), axis=1)
    b = np.sort(np.asarray(b).reshape(-1, b.shape[-1]), axis=1)
    return float(np.mean(np.all(a == b, axis=1)))


def _same_graph(port, ref):
    g, r = port.graph, ref.graph
    np.testing.assert_array_equal(g.levels.numpy(), np.asarray(r.levels))
    assert (g.entry, g.entry_level) == (int(r.entry), int(r.entry_level))
    assert _rows_equal(g.neighbors.numpy(), r.neighbors) >= 0.99
    assert port._pending_count == ref._pending_count
    assert port._level_counter == ref._level_counter


@pytest.fixture(scope="module")
def graph_ref():
    """A reference index trained with its graph, and the rows."""
    r = np.random.default_rng(14)
    base = (r.standard_normal((N + 400, D)) + 1.0).astype(np.float32)
    queries = (r.standard_normal((32, D)) + 1.0).astype(np.float32)
    ref = ref_hp.HnswPqIndex(D, CAP, "l2", RefConfig(**GRAPH_CFG))
    ref.add_batch(range(N), base[:N])
    assert ref.trained and int(ref.graph.entry) >= 0
    return ref.state_arrays(), base, queries


def _graph_pair(arrays, metric="l2", **kw):
    cfg = {**GRAPH_CFG, **kw}
    ref = ref_hp.HnswPqIndex(D, CAP, metric, RefConfig(**cfg))
    ref.load_state_arrays(arrays)
    port = hp.HnswPqIndex(D, CAP, metric, HnswPqConfig(**cfg), device="cpu")
    port.load_state_arrays(arrays)
    return ref, port


def test_graph_mode_follows_the_reference(graph_ref):
    """ADC traversal + exact re-rank from the reference's trained state
    (graph and codes loaded), adds answered through the pending overlay, the
    delta flush, delete of a pending row and of the entry point, rebuild."""
    arrays, base, queries = graph_ref
    ref, port = _graph_pair(arrays)
    assert port.resolve_mode(N) == "graph"
    _same_graph(port, ref)
    rows = {i: base[i] for i in range(N)}
    _compare(ref, port, queries, rows)

    ids = list(range(N, N + 120))               # pending: below the flush
    assert port.add_batch(ids, base[N:N + 120]) \
        == ref.add_batch(ids, base[N:N + 120])
    rows.update(zip(ids, base[N:N + 120]))
    assert port._pending_count == ref._pending_count == 120
    assert port.stats()["pending_inserts"] == 120
    _same_graph(port, ref)
    _compare(ref, port, queries, rows)
    own, _ = port.search_batch(base[N:N + 16], 1)    # found while pending
    np.testing.assert_array_equal(own[:, 0], ids[:16])
    assert port.remove(N + 5) and ref.remove(N + 5)  # never reached the graph
    del rows[N + 5]
    assert port._pending_count == ref._pending_count == 119

    ids = list(range(N + 120, N + 400))         # crosses max(64, 10%): flush
    assert port.add_batch(ids, base[N + 120:N + 400]) \
        == ref.add_batch(ids, base[N + 120:N + 400])
    rows.update(zip(ids, base[N + 120:N + 400]))
    assert port._pending_count == ref._pending_count == 0
    _same_graph(port, ref)
    _compare(ref, port, queries, rows)

    entry_id = int(port.store.state.ids[port.graph.entry])
    for vid in (entry_id, 23):
        assert port.remove(vid) and ref.remove(vid)
        del rows[vid]
    _same_graph(port, ref)
    got, _ = port.search_batch(queries, K)
    assert entry_id not in got and 23 not in got
    _compare(ref, port, queries, rows)

    port.build()
    ref.build()
    _same_graph(port, ref)
    np.testing.assert_array_equal(port.codes.numpy(), np.asarray(ref.codes))
    _compare(ref, port, queries, rows)
    s, rs = port.stats(), ref.stats()
    for key in ("index_bytes", "use_graph", "pending_inserts", "size"):
        assert s[key] == rs[key], key


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_graph_built_by_the_port_equals_the_references(metric):
    """The graph is built with exact distances from levels both packages
    draw alike, so it does not depend on the codebooks each trains: the
    port's own training ends with the reference's graph.  Under cosine the
    traversal runs in the PQ space of normalized rows."""
    r = np.random.default_rng(15)
    base = (r.standard_normal((N, D)) + 1.0).astype(np.float32)
    queries = (r.standard_normal((16, D)) + 1.0).astype(np.float32)
    ref = ref_hp.HnswPqIndex(D, CAP, metric, RefConfig(**GRAPH_CFG))
    port = hp.HnswPqIndex(D, CAP, metric, HnswPqConfig(**GRAPH_CFG),
                          device="cpu")
    assert port.add_batch(range(N), base) == ref.add_batch(range(N), base)
    assert port.trained
    _same_graph(port, ref)
    # same graph and codes: the searches agree (the reference's state)
    ref2, port2 = _graph_pair(ref.state_arrays(), metric)
    ref_ids, _ = ref2.search_batch(queries, K)
    port_ids, _ = port2.search_batch(torch.from_numpy(queries), K)
    assert _overlap(port_ids, ref_ids) >= 0.99


def test_stream_policy_inserts_into_the_graph_at_once(graph_ref):
    arrays, base, queries = graph_ref
    ref, port = _graph_pair(arrays, insert_policy="stream")
    ids = list(range(N, N + 70))
    assert port.add_batch(ids, base[N:N + 70]) \
        == ref.add_batch(ids, base[N:N + 70])
    assert port._pending_count == 0
    _same_graph(port, ref)
    rows = {i: base[i] for i in range(N + 70)}
    _compare(ref, port, queries, rows)


def test_graph_checkpoints_cross_both_ways(graph_ref):
    arrays, base, queries = graph_ref
    _, port = _graph_pair(arrays)
    ids = list(range(N, N + 100))
    port.add_batch(ids, base[N:N + 100])
    assert port._pending_count == 100
    state = port.state_arrays()                 # connects the pending rows
    assert port._pending_count == 0
    assert set(state["graph"]) == {"neighbors", "levels", "entry",
                                   "entry_level"}
    back, again = _graph_pair(state)
    _same_graph(port, back)
    _same_graph(again, back)
    rows = {i: base[i] for i in range(N + 100)}
    _compare(back, port, queries, rows)
    # a checkpoint without a graph cannot serve use_graph=True; one with a
    # graph loads into an index without (the graph is left out)
    plain = {k: v for k, v in state.items() if k != "graph"}
    with pytest.raises(ValueError, match="graph"):
        again.load_state_arrays(plain)
    flat = hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(
        num_subspaces=8, search_mode="scan_exact"), device="cpu")
    flat.load_state_arrays(state)
    assert not hasattr(flat, "graph") and "graph" not in flat.state_arrays()


def test_graph_refusals_match_the_reference():
    for kw in (dict(raw_store=False, use_graph=True),):
        with pytest.raises(ValueError) as want:
            ref_hp.HnswPqIndex(D, CAP, "l2", RefConfig(**kw))
        with pytest.raises(ValueError) as got:
            hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(**kw), device="cpu")
        assert str(got.value) == str(want.value)
    x = np.zeros((300, D), np.float32)
    with pytest.raises(ValueError) as want:
        ref_hp.HnswPqIndex(D, CAP, "l2", RefConfig(use_graph=True)
                           ).bulk_load_stream([(range(300), x)])
    with pytest.raises(ValueError) as got:
        hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(use_graph=True),
                       device="cpu").bulk_load_stream([(range(300), x)])
    assert str(got.value) == str(want.value)


def test_graph_mode_without_a_graph_runs_the_adc_scan(trained):
    """search_mode="graph" with use_graph=False: no graph exists, and both
    packages answer with the adc scan."""
    arrays, base, queries, _ = trained
    ref, port = _pair(arrays, "graph")
    _, adc_port = _pair(arrays, "adc")
    _compare(ref, port, queries, {i: base[i] for i in range(N)})
    q = torch.from_numpy(queries)
    np.testing.assert_array_equal(port.search_batch(q, K)[0],
                                  adc_port.search_batch(q, K)[0])
