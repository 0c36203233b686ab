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
    with pytest.raises(NotImplementedError, match="A10"):
        hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(use_graph=True), device="cpu")


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
    with pytest.raises(NotImplementedError, match="A10"):
        hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(search_mode="pca"),
                       device="cpu")
