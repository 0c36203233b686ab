"""The port's PCA-proxy stage (vector_db_torch/ops/pca.py) and the index's
``pca`` mode against the reference's, on the same seeded inputs.

Tolerances.  ``pca_fit`` is the reference's numpy code: mean and basis are
held bit-equal.  ``project_rows``: within one bf16 ulp (the f32 product sums
in another order before the rounding).  ``pca_proxy_search``: the reference
rounds its proxy distances to bf16 before selecting and the port selects
exactly on f32, so the pools may differ at the margin; after the exact
refine the answers must overlap the reference's >= 0.99 on average and
reach its recall against an exact oracle minus 0.005.  Whole index: the
same two bars.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from vector_db_tpu.api.config import HnswPqConfig as RefConfig  # noqa: E402
from vector_db_tpu.index import hnsw_pq as ref_hp  # noqa: E402
from vector_db_tpu.ops import pca as ref_pca  # noqa: E402
from vector_db_torch.api.config import HnswPqConfig  # noqa: E402
from vector_db_torch.index import hnsw_pq as hp  # noqa: E402
from vector_db_torch.ops import pca  # noqa: E402

D, P, N, CAP, K, S = 32, 8, 3000, 4096, 10, 8


@pytest.fixture(autouse=True)
def _full_f32_matmuls():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_float32_matmul_precision(before)


def _t(x):
    return torch.from_numpy(np.array(x))


def _corpus(n, seed, scale=1.0):
    """Rows with a decaying spectrum (what a truncated PCA needs)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, D)) * (np.arange(D) + 1.0) ** -0.8
    if scale != 1.0:   # varied norms: the cosine contract's hard case
        x = x * r.uniform(0.2, scale, (n, 1))
    return x.astype(np.float32)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _overlap(a, b, k=K):
    return float(np.mean([len(set(x) & set(y)) / k for x, y in zip(a, b)]))


def _gt(base, live, queries, metric):
    b, q = base[live].astype(np.float64), queries.astype(np.float64)
    if metric == "cosine":
        b = b / np.linalg.norm(b, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    d = ((q[:, None, :] - b[None]) ** 2).sum(-1)
    return live[np.argsort(d, axis=1)[:, :K]]


def test_pca_fit_is_the_references_basis_bit_for_bit():
    sample = _corpus(1500, 51)
    want = ref_pca.pca_fit(sample, P)
    got = pca.pca_fit(sample, P)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert got[1].shape == (D, P)
    np.testing.assert_allclose(got[1].T @ got[1], np.eye(P), atol=1e-5)


def test_project_rows_within_one_bf16_ulp():
    rows = _corpus(2000, 52)
    mu, basis = pca.pca_fit(rows[:1000], P)
    want = np.asarray(ref_pca.project_rows(
        jnp.asarray(rows), jnp.asarray(mu), jnp.asarray(basis)), np.float32)
    got = pca.project_rows(_t(rows), _t(mu), _t(basis))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2000, P)
    got = got.to(torch.float32).numpy()
    ulp = np.maximum(np.abs(want), 2.0 ** -126) * 2.0 ** -7
    assert np.all(np.abs(got - want) <= ulp)
    assert np.mean(got == want) >= 0.99


def test_rows_sq_norms_in_chunks(monkeypatch):
    proxy = _bf16(_corpus(1000, 53)[:, :P])
    want = (proxy.to(torch.float32) ** 2).sum(1)
    monkeypatch.setattr(pca, "NORM_CHUNK_ROWS", 300)
    np.testing.assert_array_equal(pca.rows_sq_norms(proxy).numpy(),
                                  want.numpy())


@pytest.mark.parametrize("metric,chunked,source", [
    ("l2", False, "f32"), ("l2", True, "f32"), ("cosine", False, "f32"),
    ("cosine", True, "f32"), ("l2", True, "int8_resid"),
    ("l2", False, "bf16")])
def test_pca_proxy_search_matches_reference(metric, chunked, source):
    """Full-row and chunked (force_chunked, block 1,024 over 3,000 rows: a
    ragged, re-sliced last chunk) under both metrics and refine stores."""
    from vector_db_tpu.ops import distance as ref_dist
    from vector_db_torch.ops import distance as dist

    base = _corpus(N, 54, scale=5.0 if metric == "cosine" else 1.0)
    queries = _corpus(24, 55)
    valid = np.ones(N, bool)
    valid[np.random.default_rng(56).choice(N, 200, replace=False)] = False
    ids = np.arange(N, dtype=np.int32) + 7
    space = base / np.linalg.norm(base, axis=1, keepdims=True) \
        if metric == "cosine" else base
    mu, basis = pca.pca_fit(space[:1500], P)
    proxy = np.asarray(ref_pca.project_rows(
        jnp.asarray(space), jnp.asarray(mu), jnp.asarray(basis)), np.float32)
    pn = (proxy * proxy).sum(1)
    kw = dict(k=16, select_r=96, metric=metric, block_n=1024,
              force_chunked=chunked)
    ref_kw, port_kw = {}, {}
    if source == "int8_resid":
        packed, scales = ref_dist.pack_int8_rows(jnp.asarray(base))
        resid, rscales = ref_dist.pack_int8_residual(jnp.asarray(base),
                                                     packed, scales)
        norms = (base * base).sum(1)
        names = ("int8_base", "int8_scales", "int8_norms", "int8_resid",
                 "int8_rscales")
        vals = [np.asarray(v) for v in (packed, scales, norms, resid,
                                        rscales)]
        ref_kw = dict(zip(names, map(jnp.asarray, vals)))
        port_kw = dict(zip(names, map(_t, vals)))
    elif source == "bf16":
        ref_kw = dict(packed_base=ref_dist.pack_bf16_rows(jnp.asarray(base)))
        port_kw = dict(packed_base=dist.pack_bf16_rows(_t(base)))
    want_d, want_i = (np.asarray(x) for x in ref_pca.pca_proxy_search(
        jnp.asarray(queries), jnp.asarray(mu), jnp.asarray(basis),
        jnp.asarray(proxy, jnp.bfloat16), jnp.asarray(pn),
        jnp.asarray(valid), jnp.asarray(base), jnp.asarray(ids), **kw,
        **ref_kw))
    got_d, got_i = (x.numpy() for x in pca.pca_proxy_search(
        _t(queries), _t(mu), _t(basis), _bf16(proxy), _t(pn), _t(valid),
        _t(base), _t(ids), **kw, **port_kw))
    gt = _gt(base, np.flatnonzero(valid), queries, metric) + 7
    got_i, want_i = got_i[:, :K], want_i[:, :K]
    assert _overlap(got_i, want_i) >= 0.99
    assert _overlap(got_i, gt) >= _overlap(want_i, gt) - 0.005
    assert _overlap(got_i, gt) >= 0.7
    same = got_i == want_i
    np.testing.assert_allclose(got_d[:, :K][same], want_d[:, :K][same],
                               rtol=1e-4, atol=1e-5)
    assert valid[got_i - 7].all()


def test_chunked_pool_equals_full_row_pool():
    """The port selects exactly, so the chunked branch (per-chunk pools of
    the full width, a ragged last chunk) keeps the pool of the full-row
    branch: the same answers, id for id."""
    base = _corpus(N, 57)
    queries = _corpus(16, 58)
    mu, basis = pca.pca_fit(base[:1500], P)
    proxy = pca.project_rows(_t(base), _t(mu), _t(basis))
    args = (_t(queries), _t(mu), _t(basis), proxy, pca.rows_sq_norms(proxy),
            torch.ones(N, dtype=torch.bool), _t(base),
            torch.arange(N, dtype=torch.int32))
    full = pca.pca_proxy_search(*args, k=16, select_r=128)
    chunked = pca.pca_proxy_search(*args, k=16, select_r=128, block_n=700,
                                   force_chunked=True)
    np.testing.assert_array_equal(full[1].numpy(), chunked[1].numpy())
    np.testing.assert_array_equal(full[0].numpy(), chunked[0].numpy())


# ------------------------------------------------------------ whole index
def _cfg(**kw):
    return dict(num_subspaces=S, training_samples=1500, search_mode="pca",
                proxy_dims=P, pca_r=96, **kw)


def _compare(ref, port, queries, rows, metric):
    ref_ids, _ = ref.search_batch(queries, K)
    port_ids, port_d = port.search_batch(torch.from_numpy(queries), K)
    ids = np.asarray(sorted(rows))
    gt = ids[_gt(np.stack([rows[i] for i in ids]), np.arange(ids.size),
                 queries, metric)]
    assert _overlap(port_ids, ref_ids) >= 0.99
    assert _overlap(port_ids, gt) >= _overlap(ref_ids, gt) - 0.005
    assert np.all(np.diff(port_d, axis=1) >= 0)


@pytest.mark.parametrize("metric,store", [("l2", "raw"), ("cosine", "raw"),
                                          ("l2", "int8_resid")])
def test_pca_mode_trains_and_searches_like_the_reference(metric, store):
    """Both packages train from the same rows (the proxy basis is fitted on
    the host from the same sample, so it is equal bit for bit), then take
    the same removes and adds; the proxy follows every encode."""
    kw = {} if store == "raw" else dict(raw_store=False, refine_residual=True)
    base = _corpus(N, 59, scale=5.0 if metric == "cosine" else 1.0)
    queries = _corpus(24, 60)
    ref = ref_hp.HnswPqIndex(D, CAP, metric, RefConfig(**_cfg(**kw)))
    port = hp.HnswPqIndex(D, CAP, metric, HnswPqConfig(**_cfg(**kw)),
                          device="cpu")
    if store == "raw":
        ref.add_batch(range(N), base)
        port.add_batch(range(N), base)
    else:
        chunks = [(range(s, s + 1500), base[s:s + 1500])
                  for s in range(0, N, 1500)]
        ref.bulk_load_stream(chunks)
        port.bulk_load_stream(chunks)
    np.testing.assert_array_equal(port.pca_mean.numpy(),
                                  np.asarray(ref.pca_mean))
    np.testing.assert_array_equal(port.pca_basis.numpy(),
                                  np.asarray(ref.pca_basis))
    got = port.proxy.to(torch.float32).numpy()
    want = np.asarray(ref.proxy, np.float32)
    assert np.all(np.abs(got - want)
                  <= np.maximum(np.abs(want), 2.0 ** -126) * 2.0 ** -7)
    assert port.stats()["proxy_bytes"] == ref.stats()["proxy_bytes"] \
        == CAP * P * 2
    assert port.stats()["index_bytes"] == ref.stats()["index_bytes"]
    rows = dict(enumerate(base))
    _compare(ref, port, queries, rows, metric)
    r = np.random.default_rng(61)
    for vid in r.choice(N, 150, replace=False).tolist():
        assert port.remove(vid) == ref.remove(vid)
        del rows[vid]
    new = _corpus(100, 62)
    new_ids = list(range(10_000, 10_100))
    assert port.add_batch(new_ids, new) == ref.add_batch(new_ids, new)
    rows.update(zip(new_ids, new))
    assert port._caches.proxy_norms.value is None  # dropped by the encode
    _compare(ref, port, queries, rows, metric)
    # every added row is found by its own vector, through the proxy
    ids, _ = port.search_batch(new[:16], 1)
    np.testing.assert_array_equal(ids[:, 0], new_ids[:16])


@pytest.mark.parametrize("store", ["raw", "int8_resid"])
def test_pca_checkpoints_cross_both_ways(store):
    """state_arrays of either package (pca_mean, pca_basis, the proxy as
    f32) loads in the other with the same answers."""
    kw = {} if store == "raw" else dict(raw_store=False, refine_residual=True)
    base, queries = _corpus(N, 64), _corpus(24, 65)
    rows = dict(enumerate(base))
    chunks = [(range(s, s + 1500), base[s:s + 1500])
              for s in range(0, N, 1500)]

    def make(pkg, config):
        return pkg.HnswPqIndex(D, CAP, "l2", config(**_cfg(**kw)),
                               **({"device": "cpu"} if pkg is hp else {}))

    # reference -> port
    ref = make(ref_hp, RefConfig)
    ref.bulk_load_stream(chunks) if kw else ref.add_batch(range(N), base)
    state = ref.state_arrays()
    assert state["proxy"].dtype == np.float32
    port = make(hp, HnswPqConfig)
    port.load_state_arrays(state)
    np.testing.assert_array_equal(
        port.proxy.to(torch.float32).numpy(), state["proxy"])
    np.testing.assert_array_equal(port.pca_basis.numpy(), state["pca_basis"])
    _compare(ref, port, queries, rows, "l2")

    # port -> reference (whose loader expects a graph: its own empty one)
    own = make(hp, HnswPqConfig)
    own.bulk_load_stream(chunks) if kw else own.add_batch(range(N), base)
    state = own.state_arrays()
    assert {"pca_mean", "pca_basis", "proxy"} <= set(state)
    assert "graph" not in state and state["proxy"].dtype == np.float32
    back = make(ref_hp, RefConfig)
    back.load_state_arrays({**state, "graph": back.state_arrays()["graph"]})
    _compare(back, own, queries, rows, "l2")
    again = make(hp, HnswPqConfig)
    again.load_state_arrays(state)
    np.testing.assert_array_equal(
        again.search_batch(torch.from_numpy(queries), K)[0],
        own.search_batch(torch.from_numpy(queries), K)[0])
    # a checkpoint without a proxy leaves pca unfitted
    plain = {k: v for k, v in state.items()
             if k not in ("pca_mean", "pca_basis", "proxy")}
    again.load_state_arrays(plain)
    assert again.proxy is None and again.stats()["proxy_bytes"] == 0


def test_pca_needs_a_fitted_proxy_like_the_reference():
    cfg = dict(num_subspaces=S, training_samples=1500, search_mode="adc")
    base = _corpus(1000, 63)
    ref = ref_hp.HnswPqIndex(D, CAP, "l2", RefConfig(**cfg))
    port = hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(**cfg), device="cpu")
    for idx in (ref, port):
        idx.add_batch(range(1000), base)
        assert idx.proxy is None and idx.stats()["proxy_bytes"] == 0
        idx.config.search_mode = "pca"       # no proxy was fitted
    with pytest.raises(ValueError) as want:
        ref.search_batch(base[:2], K)
    with pytest.raises(ValueError) as got:
        port.search_batch(base[:2], K)
    assert str(got.value) == str(want.value)
    port.build()                             # trained: re-encodes only
    assert port.proxy is None
    port.train()                             # a retrain fits it
    ids, _ = port.search_batch(base[:4], 1)
    np.testing.assert_array_equal(ids[:, 0], np.arange(4))
