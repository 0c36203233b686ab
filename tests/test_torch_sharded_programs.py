"""The port's sharded programs (``vector_db_torch/parallel/sharded.py``)
against the reference's (``vector_db_tpu/parallel/sharded.py``): the same
seeded numpy inputs, the reference on its 8-device CPU mesh under
``shard_map``, the port on 8 logical CPU shards.

Bars: the exact scans return equal ids apart from ties and distances
within rtol 1e-4; k-means steps and codebooks within 1e-4 (f32 summation
order), also when the port's row blocks split a shard; encode equal codes;
the conditioning as the single-chip shadows are held (int8 within 1 in at
most 0.1% of entries, scales and offsets within rtol 1e-5: the centering
is a sum in another order, so a scale moves by a few ulp); the
fused, flagship and PCA programs (the reference's Pallas kernels in
interpret mode, the port's plain versions, given the same conditioning,
codes or proxy) reach at least the reference's recall against an exact
oracle and share >= 99% of its ids; the merge keeps the reference's order
on planted ties across shards; the row packing is bit-equal to the
reference's host numpy packing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from vector_db_tpu.ops import adc as ref_adc  # noqa: E402
from vector_db_tpu.ops import pca as ref_pca  # noqa: E402
from vector_db_tpu.parallel import sharded as ref_sh  # noqa: E402
from vector_db_torch.ops.distance import pack_int8_rows  # noqa: E402
from vector_db_torch.parallel import sharded as sh  # noqa: E402

S, N, D, Q, K = 8, 1024, 32, 16, 10


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= S, "conftest must provide 8 devices"
    return ref_sh.make_mesh(S), sh.make_mesh(devices=[torch.device("cpu")] * S)


def _corpus(n=N, d=D, seed=0, offset=0.0):
    r = np.random.default_rng(seed)
    scale = (np.arange(d) + 1.0) ** -0.5
    return (r.standard_normal((n, d)) * scale + offset).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _both(meshes, *arrays):
    """Each numpy array sharded on both meshes: (reference, port)."""
    jm, tm = meshes
    return (ref_sh.shard_corpus(jm, *map(jnp.asarray, arrays)),
            sh.shard_corpus(tm, *map(_t, arrays)))


def _cat(pieces):
    return torch.cat(list(pieces)).numpy()


def _oracle(base, valid, q, metric="l2"):
    b, qq = base.astype(np.float64), q.astype(np.float64)
    if metric == "cosine":
        b = b / np.linalg.norm(b, axis=1, keepdims=True)
        d = -(qq / np.linalg.norm(qq, axis=1, keepdims=True)) @ b.T
    else:
        d = ((qq[:, None] - b[None]) ** 2).sum(-1)
    d[:, ~valid] = np.inf
    return np.argsort(d, axis=1)[:, :K]


def _recall(got, gt):
    return float(np.mean([len(set(g) & set(t)) / K for g, t in zip(got, gt)]))


def _same_apart_from_ties(t_out, j_out, rtol=1e-4):
    td, ti = (x.numpy() for x in t_out)
    jd, ji = (np.asarray(x) for x in j_out)
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=rtol, atol=1e-5)
    # ids differ only where the distance has a twin within the tolerance
    for row in np.argwhere((ti != ji).any(1))[:, 0]:
        np.testing.assert_allclose(np.sort(td[row]), np.sort(jd[row]),
                                   rtol=rtol, atol=1e-5)
    assert (ti == ji).mean() >= 0.98


# ------------------------------------------------------------------ packing
def test_row_packing_bit_equal_to_the_reference_host_pack():
    r = np.random.default_rng(1)
    x = (r.standard_normal((500, 64)) * r.uniform(1e-3, 50, (500, 1))
         ).astype(np.float32)
    x[7] = 0.0
    wp, ws = ref_sh._pack_rows_np(x)
    tp, ts = pack_int8_rows(_t(x))
    np.testing.assert_array_equal(tp.numpy(), wp)
    np.testing.assert_array_equal(ts.numpy(), ws)
    wr, wrs = ref_sh._pack_resid_np(x, wp, ws)
    tr, trs = sh.pack_resid(_t(x), tp, ts)
    np.testing.assert_array_equal(tr.numpy(), wr)
    np.testing.assert_array_equal(trs.numpy(), wrs)


# ----------------------------------------------------------- exact programs
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_sharded_knn_matches_reference(meshes, metric):
    base = _corpus(offset=0.2)
    valid = np.random.default_rng(2).uniform(size=N) > 0.1
    valid[:N // S] = False  # a whole shard dead
    norms = (base * base).sum(1)
    q = _corpus(Q, seed=3, offset=0.2)
    js, ts = _both(meshes, base, valid, norms)
    want = ref_sh.sharded_knn(meshes[0], K, metric)(jnp.asarray(q), *js)
    got = sh.sharded_knn(meshes[1], K, metric)(_t(q), *ts)
    _same_apart_from_ties(got, want)
    assert valid[got[1].numpy()].all()


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_dp_knn_matches_reference(meshes, metric):
    base = _corpus(300, seed=4, offset=0.2)
    valid = np.ones(300, bool)
    valid[::7] = False
    norms = (base * base).sum(1)
    q = _corpus(Q, seed=5, offset=0.2)
    want = ref_sh.dp_knn(meshes[0], K, metric)(
        jnp.asarray(q), jnp.asarray(base), jnp.asarray(valid),
        jnp.asarray(norms))
    got = sh.dp_knn(meshes[1], K, metric)(_t(q), _t(base), _t(valid),
                                          _t(norms))
    _same_apart_from_ties(got, want)
    with pytest.raises(ValueError):
        sh.dp_knn(meshes[1], K)(_t(q[:5]), _t(base), _t(valid), _t(norms))


def _packed_store(base, residual):
    packed, scales = ref_sh._pack_rows_np(base)
    out = [packed, scales]
    if residual:
        out += list(ref_sh._pack_resid_np(base, packed, scales))
    return out


@pytest.mark.parametrize("residual", [False, True])
def test_sharded_knn_int8_matches_reference(meshes, residual):
    base = _corpus(seed=6)
    valid = np.random.default_rng(7).uniform(size=N) > 0.2
    norms = (base * base).sum(1)
    packed, scales, *res = _packed_store(base, residual)
    q = _corpus(Q, seed=8)
    js, ts = _both(meshes, packed, scales, valid, norms, *res)
    want = ref_sh.sharded_knn_int8(meshes[0], K, residual=residual)(
        jnp.asarray(q), *js)
    got = sh.sharded_knn_int8(meshes[1], K, residual=residual)(_t(q), *ts)
    _same_apart_from_ties(got, want)


# ------------------------------------------------------- training, encode
def test_kmeans_step_matches_reference(meshes):
    data = _corpus(seed=9)
    cents = data[:16].copy()
    (jd,), (td,) = _both(meshes, data)
    want = ref_sh.sharded_kmeans_step(meshes[0])(
        jd, ref_sh.replicate(meshes[0], jnp.asarray(cents))[0])
    got = sh.sharded_kmeans_step(meshes[1])(td, _t(cents))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("norm_rows,chunk_rows", [(False, 0), (True, 0),
                                                  (False, 24)])
def test_subspace_kmeans_matches_reference(meshes, monkeypatch, norm_rows,
                                           chunk_rows):
    s, kc, iters = 4, 16, 5
    data = _corpus(seed=10, offset=0.1)
    r = np.random.default_rng(11)
    w = (r.uniform(size=N) > 0.1).astype(np.float32)
    perm = r.permutation(D)
    pick = data[r.choice(N, kc, replace=False)]
    if norm_rows:
        pick = pick / np.linalg.norm(pick, axis=1, keepdims=True)
    init = pick[:, perm].reshape(kc, s, D // s).transpose(1, 0, 2).copy()
    if chunk_rows:  # row blocks of 24 split each 128-row shard
        monkeypatch.setattr(sh, "KMEANS_CHUNK_BYTES", 4 * s * kc * chunk_rows)
    js, ts = _both(meshes, data, w)
    want = ref_sh.sharded_subspace_kmeans(meshes[0], s, iters, norm_rows)(
        js[0], jnp.asarray(init), js[1], jnp.asarray(perm))
    got = sh.sharded_subspace_kmeans(meshes[1], s, iters, norm_rows)(
        ts[0], _t(init), ts[1], _t(perm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_sharded_encode_codes_equal(meshes):
    data = _corpus(seed=12)
    cb = np.random.default_rng(13).standard_normal((8, 16, 4)).astype(
        np.float32) * 0.3
    perm = np.random.default_rng(14).permutation(D)
    for norm_rows in (False, True):
        (jd,), (td,) = _both(meshes, data)
        want = ref_sh.sharded_encode(meshes[0], norm_rows)(
            jd, jnp.asarray(cb), jnp.asarray(perm))
        got = sh.sharded_encode(meshes[1], norm_rows)(td, _t(cb), _t(perm))
        np.testing.assert_array_equal(_cat(got), np.asarray(want))


# ----------------------------------------------------------- conditioning
def _assert_int8_close(got, want):
    diff = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def _assert_off_close(got, want):
    want = np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


def _raw_store(seed, metric):
    base = _corpus(seed=seed, offset=1.0 if metric == "l2" else 2.0)
    valid = np.random.default_rng(seed + 1).uniform(size=N) > 0.1
    return base, (base * base).sum(1), valid


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_cond_raw8_and_raw8g_match_reference(meshes, metric):
    base, norms, valid = _raw_store(15, metric)
    js, ts = _both(meshes, base, norms, valid)
    jb8, joff, jsc, jc = ref_sh.sharded_cond_raw8(meshes[0], metric)(*js)
    tb8, toff, tsc, tc = sh.sharded_cond_raw8(meshes[1], metric)(*ts)
    _assert_int8_close(_cat(tb8), jb8)
    _assert_off_close(_cat(toff), joff)
    np.testing.assert_allclose(_cat(tsc), np.asarray(jsc), rtol=1e-5)
    np.testing.assert_allclose(_cat(tc), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    jb8, joff, jsv, jc = ref_sh.sharded_cond_raw8g(meshes[0], metric)(*js)
    tb8, toff, tsv, tc = sh.sharded_cond_raw8g(meshes[1], metric)(*ts)
    assert _cat(tsv).shape == (S,)
    _assert_int8_close(_cat(tb8), jb8)
    _assert_off_close(_cat(toff), joff)
    np.testing.assert_allclose(_cat(tsv), np.asarray(jsv), rtol=1e-5)
    np.testing.assert_allclose(_cat(tc), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_cond_int8_matches_reference(meshes, metric):
    base, norms, valid = _raw_store(17, metric)
    packed, scales = ref_sh._pack_rows_np(base)
    js, ts = _both(meshes, packed, scales, norms, valid)
    joff, jsc, jc = ref_sh.sharded_cond_int8(meshes[0], metric)(*js)
    toff, tsc, tc = sh.sharded_cond_int8(meshes[1], metric)(*ts)
    _assert_off_close(_cat(toff), joff)
    np.testing.assert_allclose(_cat(tsc), np.asarray(jsc), rtol=1e-5)
    np.testing.assert_allclose(_cat(tc), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------ fused scans
def _hold_search(got, want, gt):
    """At least the reference's recall, >= 99% of its ids."""
    gi, wi = got[1].numpy(), np.asarray(want[1])
    assert _recall(gi, gt) >= _recall(wi, gt)
    assert (gi == wi).mean() >= 0.99


@pytest.mark.parametrize("kind,metric", [("raw8", "l2"), ("raw8", "cosine"),
                                         ("raw8g", "l2"),
                                         ("raw8g", "cosine")])
def test_fused_raw_programs_match_reference(meshes, kind, metric):
    base, norms, valid = _raw_store(19, metric)
    q = base[:Q] + 0.05 * _corpus(Q, seed=20)
    js, ts = _both(meshes, base, norms, valid)
    cond = getattr(ref_sh, f"sharded_cond_{kind}")(meshes[0], metric)(*js)
    # the same conditioning on both sides: the pools are held, not it
    tcond = [sh.shard_corpus(meshes[1], _t(c))[0] for c in cond]
    w = 128  # per shard 128 rows: the widest preserved width
    want = getattr(ref_sh, f"sharded_fused_{kind}")(
        meshes[0], K, 32, w, metric)(jnp.asarray(q), js[0], *cond)
    got = getattr(sh, f"sharded_fused_{kind}")(meshes[1], K, 32, w, metric)(
        _t(q), ts[0], *tcond)
    _hold_search(got, want, _oracle(base, valid, q, metric))


@pytest.mark.parametrize("metric,residual", [("l2", False), ("l2", True),
                                             ("cosine", True)])
def test_fused_int8_program_matches_reference(meshes, metric, residual):
    base, norms, valid = _raw_store(21, metric)
    packed, scales, *res = _packed_store(base, residual)
    q = base[:Q] + 0.05 * _corpus(Q, seed=22)
    js, ts = _both(meshes, packed, scales, norms, valid, *res)
    cond = ref_sh.sharded_cond_int8(meshes[0], metric)(*js[:4])
    tcond = [sh.shard_corpus(meshes[1], _t(c))[0] for c in cond]
    want = ref_sh.sharded_fused_int8(meshes[0], K, 32, 128, metric,
                                     residual)(
        jnp.asarray(q), js[0], js[1], js[2], *cond, *js[4:])
    got = sh.sharded_fused_int8(meshes[1], K, 32, 128, metric, residual)(
        _t(q), ts[0], ts[1], ts[2], *tcond, *ts[4:])
    _hold_search(got, want, _oracle(base, valid, q, metric))


# ------------------------------------------------------- flagship and PCA
def _pq(base, s=8, kc=32):
    cb = base[np.random.default_rng(23).choice(len(base), kc, replace=False)]
    cb = cb.reshape(kc, s, D // s).transpose(1, 0, 2).copy()
    return cb, np.asarray(ref_adc.pq_encode(jnp.asarray(base),
                                            jnp.asarray(cb)))


@pytest.mark.parametrize("tier", ["raw", "int8", "int8_resid"])
def test_flagship_programs_match_reference(meshes, tier):
    base = _corpus(seed=24)
    valid = np.ones(N, bool)
    valid[5::11] = False
    ids = np.arange(1000, 1000 + N, dtype=np.int32)
    cb, codes = _pq(base)
    perm = np.arange(D, dtype=np.int32)
    q = np.concatenate([base[:8], _corpus(8, seed=25)])
    if tier == "raw":
        payload = (base, ids)
        want_fn = ref_sh.sharded_flagship(meshes[0], K, 64)
        got_fn = sh.sharded_flagship(meshes[1], K, 64)
    else:
        residual = tier == "int8_resid"
        payload = (*_packed_store(base, False)[:2], (base * base).sum(1), ids)
        res = _packed_store(base, True)[2:] if residual else []
        want_fn = ref_sh.sharded_flagship_int8(meshes[0], K, 64,
                                               residual=residual)
        got_fn = sh.sharded_flagship_int8(meshes[1], K, 64,
                                          residual=residual)
    js, ts = _both(meshes, codes, valid, *payload)
    tail = []
    if tier == "int8_resid":
        jr, tr = _both(meshes, *res)
        tail = [jr, tr]
    want = want_fn(jnp.asarray(q), jnp.asarray(cb), *js, jnp.asarray(perm),
                   *(tail[0] if tail else ()))
    got = got_fn(_t(q), _t(cb), *ts, _t(perm), *(tail[1] if tail else ()))
    gt = _oracle(base, valid, q) + 1000
    _hold_search(got, want, gt)
    live = valid[:8]
    assert (got[1].numpy()[:8, 0][live] == ids[:8][live]).all()


@pytest.mark.parametrize("tier", ["raw", "int8_resid"])
def test_pca_programs_match_reference(meshes, tier):
    base = _corpus(seed=26)
    valid = np.ones(N, bool)
    valid[3::13] = False
    ids = np.arange(N, dtype=np.int32)
    mu, basis = ref_pca.pca_fit(base[:512], 8)
    proxy = ref_pca.project_rows(jnp.asarray(base), jnp.asarray(mu),
                                 jnp.asarray(basis))
    proxy32 = np.asarray(proxy.astype(jnp.float32))
    pnorms = (proxy32 * proxy32).sum(1)
    q = np.concatenate([base[:8], _corpus(8, seed=27)])
    head_j = (jnp.asarray(q), jnp.asarray(mu), jnp.asarray(basis))
    head_t = (_t(q), _t(mu), _t(basis))
    (jp,) = ref_sh.shard_corpus(meshes[0], proxy)
    (tp,) = sh.shard_corpus(meshes[1], _t(proxy32).to(torch.bfloat16))
    if tier == "raw":
        js, ts = _both(meshes, pnorms, valid, base, ids)
        want = ref_sh.sharded_pca_search(meshes[0], K, 64)(*head_j, jp, *js)
        got = sh.sharded_pca_search(meshes[1], K, 64)(*head_t, tp, *ts)
    else:
        store = _packed_store(base, True)
        js, ts = _both(meshes, pnorms, valid, store[0], store[1],
                       (base * base).sum(1), ids, store[2], store[3])
        want = ref_sh.sharded_pca_search_int8(meshes[0], K, 64,
                                              residual=True)(
            *head_j, jp, *js)
        got = sh.sharded_pca_search_int8(meshes[1], K, 64, residual=True)(
            *head_t, tp, *ts)
    _hold_search(got, want, _oracle(base, valid, q))
    live = valid[:8]
    assert (got[1].numpy()[:8, 0][live] == np.arange(8)[live]).all()


# ------------------------------------------------------------------- merge
def test_merge_keeps_the_reference_order_on_ties(meshes):
    """Planted ties across and within shards: the same ids in the same
    order as ``lax.top_k`` (earlier shard, then earlier position)."""
    r = np.random.default_rng(28)
    kk, qn = 4, 6
    d = r.integers(0, 3, (S, qn, kk)).astype(np.float32)  # many ties
    d[2, 0] = np.inf
    e = np.arange(S * qn * kk, dtype=np.int32).reshape(S, qn, kk)
    jm, tm = meshes
    axis = ref_sh.AXIS
    merge = jax.jit(jax.shard_map(
        lambda dd, ee: ref_sh._merge_topk(dd[0], ee[0], 7), mesh=jm,
        in_specs=(P(axis), P(axis)), out_specs=(P(), P()), check_vma=False))
    wd, we = merge(jnp.asarray(d), jnp.asarray(e))
    td, te = sh._merge_topk(tm, list(_t(d)), list(_t(e)), 7)
    np.testing.assert_array_equal(td.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(te.numpy(), np.asarray(we))
