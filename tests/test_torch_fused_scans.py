"""The port's other fused scans against the reference's, on the CPU: the
pool kernels' plain versions fused_int8g_pool (B7), fused_raw_pool (B6)
and fused_adc_pool (B5) against the Pallas kernels in interpret mode, the
global-scale int8 and the bf16 scan shadows with their incremental
refreshes, and HnswPqIndex in scan_pallas, scan_pallas_int8 with
int8_epilogue="global", scan_bf16 and adc_fast with adc_pool="fused".

Tolerances: B7 is integer arithmetic with the reference's f32
conditioning, so vals and slots are bit-equal.  B6 and B5 sum exact bf16
products in f32 in another order than XLA: ``ops/kernels.check_float_pool``
(slots agree in >= 99.9% of entries, values within 2 d 2^-24 (|q|.|v|) |sc|
plus one ulp of the score).  The shadows: int8 entries within 1 in at most
0.1% of entries (XLA and PyTorch may round the division differently by an
ulp), f32 terms within rtol 1e-5, bf16 rows equal.  Searches: mean top-10
overlap with the reference >= 0.99 and recall against an exact oracle no
lower than the reference's minus 0.005.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from vector_db_tpu.api.config import HnswPqConfig as RefConfig  # noqa: E402
from vector_db_tpu.index import hnsw_pq as ref_hp  # noqa: E402
from vector_db_tpu.index.base import pad_queries_pow2 as ref_pad  # noqa: E402
from vector_db_tpu.ops import pallas_kernels as ref_pk  # noqa: E402
from vector_db_torch.api.config import HnswPqConfig  # noqa: E402
from vector_db_torch.index import hnsw_pq as hp  # noqa: E402
from vector_db_torch.index.base import pad_queries_pow2  # noqa: E402
from vector_db_torch.ops import kernels as tk  # noqa: E402

D, N, CAP, K = 32, 3000, 4096, 10


def _t(x):
    return torch.from_numpy(np.array(x))


def _store(n, d, dead, seed, offset=2.0):
    r = np.random.default_rng(seed)
    base = (r.standard_normal((n, d)) + offset).astype(np.float32)
    valid = np.ones(n, bool)
    valid[r.choice(n, int(dead * n), replace=False)] = False
    return base, (base * base).sum(1), valid, r


def _queries(r, qn, d, cvec, metric, offset=2.0):
    q = (r.standard_normal((qn, d)) + offset).astype(np.float32)
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    return q - np.asarray(cvec)[None, :]


def _overlap(a, b):
    return float(np.mean([len(set(x) & set(y)) / K for x, y in zip(a, b)]))


def _oracle(rows: dict, queries, metric="l2"):
    ids = np.asarray(sorted(rows))
    mat = np.stack([rows[i] for i in ids]).astype(np.float64)
    q = queries.astype(np.float64)
    if metric == "cosine":
        mat = mat / np.linalg.norm(mat, axis=1, keepdims=True)
        d = -(q / np.linalg.norm(q, axis=1, keepdims=True)) @ mat.T
    else:
        d = ((q[:, None, :] - mat[None]) ** 2).sum(-1)
    return ids[np.argsort(d, axis=1)[:, :K]]


# ---------------------------------------------------- fused_int8g_pool (B7)
def _ref_g_shadow(base, norms, valid, metric, pad_to=1):
    out = ref_hp._build_scan8g_shadow(jnp.asarray(base), jnp.asarray(norms),
                                      jnp.asarray(valid), metric, pad_to)
    base8, off, sv, sgn, cvec, _ = out
    return np.array(base8), np.array(off), np.array(sv), float(sgn), cvec


@pytest.mark.parametrize(
    "qn,n,w,metric,dead",
    [
        (1, 3000, 256, "l2", 0.1),       # one query, ragged N
        (5, 3000, 64, "cosine", 0.0),    # w below block_n
        (8, 4096, 512, "l2", 0.2),       # N a multiple of w
        (5, 2500, 700, "cosine", 0.3),   # w rounds to 1024, ragged N
        (8, 1111, 2048, "l2", 0.0),      # fewer rows than one pass
        (1, 4096, 2048, "cosine", 0.2),  # one query, whole passes
    ],
)
def test_int8g_plain_bit_equal_to_reference(qn, n, w, metric, dead):
    base, norms, valid, r = _store(n, D, dead, seed=qn + n)
    base8, off, sv, sgn, cvec = _ref_g_shadow(base, norms, valid, metric)
    qc = _queries(r, qn, D, cvec, metric)
    jv, js = ref_pk.fused_int8g_pool(jnp.asarray(qc), jnp.asarray(base8),
                                     jnp.asarray(off), jnp.asarray(sv), sgn,
                                     w, interpret=True)
    tv, ts = tk.fused_int8g_pool(_t(qc), _t(base8), _t(off), _t(sv), sgn, w)
    assert tuple(tv.shape) == np.asarray(jv).shape == (qn, tk.pool_width(w))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    live = ts.numpy()[ts.numpy() >= 0]
    assert live.max() < n and np.isfinite(off[live]).all()


@pytest.mark.parametrize("qn", [1, 5])
def test_int8g_batch_scale_covers_the_padded_rows(qn):
    """The batch scale is taken over the pow2-padded batch, whose zero rows
    center to -center_vec (a quirk of the reference the port keeps): the
    pool equals the reference's on the padded batch, and differs from the
    pool of the unpadded rows alone."""
    base, norms, valid, r = _store(3000, D, 0.1, seed=40 + qn)
    base8, off, sv, sgn, cvec = _ref_g_shadow(base, norms, valid, "l2")
    # queries near the corpus: the centered pad rows (-center_vec) are wider
    raw = (r.standard_normal((qn, D)) * 0.3 + 2.0).astype(np.float32)
    padded_j, _ = ref_pad(raw)
    padded_t, _ = pad_queries_pow2(_t(raw))
    np.testing.assert_array_equal(padded_t.numpy(), np.asarray(padded_j))
    qc = padded_t.numpy() - np.asarray(cvec)[None, :]
    assert np.abs(qc).max() > np.abs(qc[:qn]).max()  # the pad rows widen sq
    jv, js = ref_pk.fused_int8g_pool(jnp.asarray(qc), jnp.asarray(base8),
                                     jnp.asarray(off), jnp.asarray(sv), sgn,
                                     512, interpret=True)
    tv, ts = tk.fused_int8g_pool(_t(qc), _t(base8), _t(off), _t(sv), sgn, 512)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    alone, _ = tk.fused_int8g_pool(_t(qc[:qn]), _t(base8), _t(off), _t(sv),
                                   sgn, 512)
    assert not torch.equal(alone, tv[:qn])


# ------------------------------------------------------ fused_raw_pool (B6)
def _raw_case(qn, n, w, metric, dead):
    base, norms, valid, r = _store(n, D, dead, seed=100 + qn + n)
    base16, off, sc, cvec, _ = ref_hp._build_scan16_shadow(
        jnp.asarray(base), jnp.asarray(norms), jnp.asarray(valid), metric, 1)
    qc = _queries(r, qn, D, cvec, metric)
    want = ref_pk.fused_raw_pool(jnp.asarray(qc), base16, off, sc, w,
                                 interpret=True)
    t16 = _t(np.asarray(base16.astype(jnp.float32))).to(torch.bfloat16)
    return qc, t16, _t(off), _t(sc), want


@pytest.mark.parametrize(
    "qn,n,w,metric,dead",
    [
        (13, 3000, 64, "l2", 0.1),
        (1, 3000, 2048, "cosine", 0.0),
        (16, 2500, 700, "l2", 0.3),
        (8, 4096, 512, "cosine", 0.2),
    ],
)
def test_raw_plain_matches_reference_kernel(qn, n, w, metric, dead):
    qc, t16, off, sc, (jv, js) = _raw_case(qn, n, w, metric, dead)
    got = tk.fused_raw_pool(_t(qc), t16, off, sc, w)
    assert tuple(got[0].shape) == (qn, tk.pool_width(w))
    res = tk.check_float_pool(
        got, (_t(jv), _t(js)),
        lambda s: tk.raw_pool_terms(_t(qc), t16, off, sc, s),
        tk.pool_width(w))
    assert res["ok"], res


def test_raw_pool_rounds_queries_to_bf16():
    """The queries are rounded to bf16 before the product: queries that
    round alike pool alike."""
    qc, t16, off, sc, _ = _raw_case(4, 2048, 256, "l2", 0.0)
    q = _t(qc).to(torch.bfloat16).to(torch.float32)  # bf16 values
    nudged = q + q.abs() * 2.0 ** -12  # well below half a bf16 ulp
    assert torch.equal(q.to(torch.bfloat16), nudged.to(torch.bfloat16))
    a = tk.fused_raw_pool(q, t16, off, sc, 256)
    b = tk.fused_raw_pool(nudged, t16, off, sc, 256)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_raw_plain_matches_reference_kernel_past_the_resident_tile():
    """B6 at d = 768: past the 640 dims whose query tile the card's wgmma
    loop keeps resident (it streams the tile there), the plain version
    still agrees with the reference."""
    d = 768
    base, norms, valid, r = _store(3000, d, 0.1, seed=65)
    base16, off, sc, cvec, _ = ref_hp._build_scan16_shadow(
        jnp.asarray(base), jnp.asarray(norms), jnp.asarray(valid), "l2", 1)
    assert tk.wgmma_plan(2 * d, tk.BF16_POOL_STAGES)[1]  # streamed
    qc = _queries(r, 9, d, cvec, "l2")
    jv, js = ref_pk.fused_raw_pool(jnp.asarray(qc), base16, off, sc, 512,
                                   interpret=True)
    t16 = _t(np.asarray(base16.astype(jnp.float32))).to(torch.bfloat16)
    got = tk.fused_raw_pool(_t(qc), t16, _t(off), _t(sc), 512)
    res = tk.check_float_pool(
        got, (_t(jv), _t(js)),
        lambda s: tk.raw_pool_terms(_t(qc), t16, _t(off), _t(sc), s), 512)
    assert res["ok"], res


# ------------------------------------------------------ fused_adc_pool (B5)
@pytest.mark.parametrize(
    "qn,n,w,k,s,sd",
    [
        (5, 3000, 256, 256, 8, 4),     # ragged N
        (1, 4000, 2048, 200, 8, 4),    # K padded to 256 by the reference
        (16, 2048, 512, 256, 16, 2),   # N a multiple of w
        (8, 1500, 300, 200, 4, 8),     # w rounds to 512, one ragged pass
    ],
)
def test_adc_plain_matches_reference_kernel(qn, n, w, k, s, sd):
    r = np.random.default_rng(qn * 7 + k)
    codes = r.integers(0, k, (s, n), dtype=np.uint8)
    cbt = (r.standard_normal((s * sd, k)) * 0.5).astype(np.float32)
    norms = np.where(r.uniform(size=n) > 0.15,
                     r.uniform(1, 30, n), np.inf).astype(np.float32)
    q = r.standard_normal((qn, s * sd)).astype(np.float32)
    jv, js = ref_pk.fused_adc_pool(jnp.asarray(q), jnp.asarray(codes),
                                   jnp.asarray(cbt), jnp.asarray(norms), w,
                                   interpret=True)
    got = tk.fused_adc_pool(_t(q), _t(codes), _t(cbt), _t(norms), w)
    assert tuple(got[0].shape) == np.asarray(jv).shape == (
        qn, tk.pool_width(w))
    res = tk.check_float_pool(
        got, (_t(jv), _t(js)),
        lambda sl: tk.adc_pool_terms(_t(q), _t(codes), _t(cbt), _t(norms),
                                     sl),
        tk.pool_width(w))
    assert res["ok"], res


def test_adc_plain_matches_reference_kernel_past_the_resident_tile():
    """B5 at d = 768 (S = 96, sd = 8), as B6 above."""
    s, sd, k, n = 96, 8, 256, 3000
    r = np.random.default_rng(66)
    codes = r.integers(0, k, (s, n), dtype=np.uint8)
    cbt = (r.standard_normal((s * sd, k)) * 0.5).astype(np.float32)
    norms = np.where(r.uniform(size=n) > 0.1, r.uniform(1, 30, n),
                     np.inf).astype(np.float32)
    q = r.standard_normal((7, s * sd)).astype(np.float32)
    jv, js = ref_pk.fused_adc_pool(jnp.asarray(q), jnp.asarray(codes),
                                   jnp.asarray(cbt), jnp.asarray(norms), 512,
                                   interpret=True)
    got = tk.fused_adc_pool(_t(q), _t(codes), _t(cbt), _t(norms), 512)
    res = tk.check_float_pool(
        got, (_t(jv), _t(js)),
        lambda sl: tk.adc_pool_terms(_t(q), _t(codes), _t(cbt), _t(norms),
                                     sl), 512)
    assert res["ok"], res


def test_adc_pool_reads_a_column_slice_like_a_copy():
    r = np.random.default_rng(3)
    codes = torch.from_numpy(r.integers(0, 256, (8, 5000), dtype=np.uint8))
    cbt = torch.from_numpy(r.standard_normal((32, 256)).astype(np.float32))
    norms = torch.from_numpy(r.uniform(1, 9, 2000).astype(np.float32))
    q = torch.from_numpy(r.standard_normal((3, 32)).astype(np.float32))
    part = codes[:, 1000:3000]
    a = tk.fused_adc_pool(q, part, cbt, norms, 512)
    b = tk.fused_adc_pool(q, part.contiguous(), cbt, norms, 512)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------- shadows
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_scan8g_shadow_matches_reference(metric):
    base, norms, valid, _ = _store(3000, 30, 0.2, seed=12, offset=1.0)
    want = ref_hp._build_scan8g_shadow(jnp.asarray(base), jnp.asarray(norms),
                                       jnp.asarray(valid), metric, 2048)
    base8, off, sv, sgn, cvec, aux = hp._build_scan8g_shadow(
        _t(base), _t(norms), _t(valid), metric, 2048)
    assert tuple(base8.shape) == (4096, 32) and (base8[:, 30:] == 0).all()
    diff = np.abs(base8[:, :30].numpy().astype(np.int32)
                  - np.asarray(want[0]).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    off_j = np.asarray(want[1])
    np.testing.assert_array_equal(np.isfinite(off.numpy()), np.isfinite(off_j))
    fin = np.isfinite(off_j)
    np.testing.assert_allclose(off.numpy()[fin], off_j[fin], rtol=1e-5)
    np.testing.assert_allclose(sv.numpy(), np.asarray(want[2]), rtol=1e-6)
    assert sgn == float(want[3])
    np.testing.assert_allclose(cvec.numpy(), np.asarray(want[4]), rtol=1e-5)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want[5]), rtol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_scan16_shadow_matches_reference(metric):
    base, norms, valid, _ = _store(3000, 30, 0.2, seed=13, offset=1.0)
    want = ref_hp._build_scan16_shadow(jnp.asarray(base), jnp.asarray(norms),
                                       jnp.asarray(valid), metric, 2048)
    base16, off, sc, cvec, aux = hp._build_scan16_shadow(
        _t(base), _t(norms), _t(valid), metric, 2048)
    assert tuple(base16.shape) == (4096, 32) and (base16[:, 30:] == 0).all()
    np.testing.assert_array_equal(
        base16[:, :30].to(torch.float32).numpy(),
        np.asarray(want[0].astype(jnp.float32)))
    off_j = np.asarray(want[1])
    np.testing.assert_array_equal(np.isfinite(off.numpy()), np.isfinite(off_j))
    fin = np.isfinite(off_j)
    scale = np.abs(off_j[fin]).max()
    np.testing.assert_allclose(off.numpy()[fin], off_j[fin], rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(sc.numpy(), np.asarray(want[2]), rtol=1e-6)
    np.testing.assert_allclose(cvec.numpy(), np.asarray(want[3]), rtol=1e-5)
    for a, b in zip(aux, want[4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def _mutated_store(seed):
    """A store of 8192 slots and the same store with 200 slots past the
    centering prefix (the first 4096) rewritten or deleted."""
    base, norms, valid, r = _store(8192, D, 0.1, seed=seed, offset=1.0)
    slots = np.sort(r.choice(np.arange(4096, 8192), 200, replace=False))
    new = base.copy()
    new[slots] = (r.standard_normal((200, D)) * 0.5 + 1.0).astype(np.float32)
    nvalid = valid.copy()
    nvalid[slots[::5]] = False
    return (base, norms, valid), (new, (new * new).sum(1), nvalid), slots


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_scan8g_update_equals_rebuild(metric):
    old, new, slots = _mutated_store(14)
    base8, off, sv, sgn, cvec, aux = hp._build_scan8g_shadow(
        *map(_t, old), metric, 2048)
    clipped = hp._update_scan8g_shadow(base8, off, *map(_t, new),
                                       _t(slots), cvec, aux, sv, metric)
    assert clipped == 0  # the new rows lie inside the calibrated range
    want = hp._build_scan8g_shadow(*map(_t, new), metric, 2048)
    assert torch.equal(want[2], sv) or float(want[2]) < float(sv)
    fresh = hp._quantize_global_rows(*(_t(a[slots]) for a in new[:1]),
                                     _t(new[1][slots]), _t(new[2][slots]),
                                     cvec, aux, sv, metric)
    assert torch.equal(base8[_t(slots)], fresh[0])
    if torch.equal(want[2], sv):
        assert torch.equal(base8, want[0])
        np.testing.assert_allclose(off.numpy(), want[1].numpy(), rtol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_scan16_update_equals_rebuild(metric):
    """The bf16 rows and scales equal a rebuild's; the offsets equal it up
    to one constant (under L2 the rebuild's mean norm moved with the
    rewritten rows; a constant does not change any ranking)."""
    old, new, slots = _mutated_store(15)
    base16, off, sc, cvec, aux = hp._build_scan16_shadow(
        *map(_t, old), metric, 2048)
    hp._update_scan16_shadow(base16, off, sc, *map(_t, new), _t(slots), cvec,
                             aux, metric)
    w16, woff, wsc, wcvec, _ = hp._build_scan16_shadow(*map(_t, new), metric,
                                                       2048)
    assert torch.equal(base16, w16) and torch.equal(cvec, wcvec)
    np.testing.assert_allclose(sc.numpy(), wsc.numpy(), rtol=1e-6)
    fin = torch.isfinite(woff)
    assert torch.equal(fin, torch.isfinite(off))
    shift = (off[fin] - woff[fin]).numpy()
    np.testing.assert_allclose(shift, np.full_like(shift, shift.mean()),
                               atol=1e-4 * np.abs(woff[fin].numpy()).max())


# ------------------------------------------------------------------ index
@pytest.fixture(scope="module")
def trained():
    """(reference state_arrays of a trained index, corpus, queries)."""
    r = np.random.default_rng(16)
    base = (r.standard_normal((N, D)) + 1.0).astype(np.float32)
    queries = (r.standard_normal((32, D)) + 1.0).astype(np.float32)
    ref = ref_hp.HnswPqIndex(D, CAP, "l2",
                             RefConfig(num_subspaces=8, training_samples=2000))
    ref.add_batch(range(N), base)
    return ref.state_arrays(), base, queries


MODES = [("scan_pallas", {}),
         ("scan_pallas_int8", {"int8_epilogue": "global"}),
         ("scan_bf16", {}),
         ("adc_fast", {"adc_pool": "fused"})]


@pytest.mark.parametrize("mode,extra", MODES,
                         ids=["scan_pallas", "int8_global", "scan_bf16",
                              "adc_fused"])
def test_index_modes_match_reference_before_and_after_churn(trained, mode,
                                                            extra):
    arrays, base, queries = trained
    cfg = dict(num_subspaces=8, search_mode=mode, **extra)
    ref = ref_hp.HnswPqIndex(D, CAP, "l2", RefConfig(**cfg))
    ref.load_state_arrays(arrays)
    port = hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(**cfg), device="cpu")
    port.load_state_arrays(arrays)
    rows = {i: base[i] for i in range(N)}
    r = np.random.default_rng(17)
    for step in range(2):
        if step:  # churn: the shadows refresh incrementally
            for vid in r.choice(N, 200, replace=False).tolist():
                assert port.remove(vid) == ref.remove(vid)
                del rows[vid]
            new = (r.standard_normal((150, D)) + 1.0).astype(np.float32)
            new_ids = list(range(10_000, 10_150))
            assert port.add_batch(new_ids, new) == ref.add_batch(new_ids, new)
            rows.update(zip(new_ids, new))
        ref_ids, _ = ref.search_batch(queries, K)
        port_ids, port_d = port.search_batch(torch.from_numpy(queries), K)
        gt = _oracle(rows, queries)
        assert _overlap(port_ids, ref_ids) >= 0.99
        assert _overlap(port_ids, gt) >= _overlap(ref_ids, gt) - 0.005
        assert np.all(np.diff(port_d, axis=1) >= 0)
    if mode == "scan_pallas":
        assert port._caches.scan16.key == port.store.version
    if extra.get("int8_epilogue"):
        assert port._caches.scan8g.key == port.store.version


@pytest.mark.parametrize("mode,extra", MODES[:3],
                         ids=["scan_pallas", "int8_global", "scan_bf16"])
def test_cosine_index_modes_match_reference(mode, extra):
    r = np.random.default_rng(18)
    base = ((r.standard_normal((N, D)) + 0.5)
            * r.uniform(0.5, 3.0, (N, 1))).astype(np.float32)
    queries = (r.standard_normal((24, D)) + 0.5).astype(np.float32)
    cfg = dict(num_subspaces=8, training_samples=2000, search_mode=mode,
               **extra)
    ref = ref_hp.HnswPqIndex(D, CAP, "cosine", RefConfig(**cfg))
    ref.add_batch(range(N), base)
    port = hp.HnswPqIndex(D, CAP, "cosine", HnswPqConfig(**cfg),
                          device="cpu")
    port.load_state_arrays(ref.state_arrays())
    ref_ids, _ = ref.search_batch(queries, K)
    port_ids, _ = port.search_batch(torch.from_numpy(queries), K)
    gt = _oracle(dict(enumerate(base)), queries, "cosine")
    assert _overlap(port_ids, ref_ids) >= 0.99
    assert _overlap(port_ids, gt) >= _overlap(ref_ids, gt) - 0.005


@pytest.mark.parametrize("qn", [1, 5])
def test_int8_global_small_batches_equal_reference(trained, qn):
    """At Q=1 and Q=5 the batch scale covers the pow2 padding rows in both
    packages: the same ids and distances."""
    arrays, _, queries = trained
    cfg = dict(num_subspaces=8, search_mode="scan_pallas_int8",
               int8_epilogue="global")
    ref = ref_hp.HnswPqIndex(D, CAP, "l2", RefConfig(**cfg))
    ref.load_state_arrays(arrays)
    port = hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(**cfg), device="cpu")
    port.load_state_arrays(arrays)
    ref_ids, ref_d = ref.search_batch(queries[:qn], K)
    port_ids, port_d = port.search_batch(torch.from_numpy(queries[:qn]), K)
    np.testing.assert_array_equal(port_ids, ref_ids)
    np.testing.assert_allclose(port_d, ref_d, rtol=1e-4, atol=1e-5)


def test_clipped_rows_force_a_global_shadow_rebuild(trained):
    """Rows wider than the calibrated range clip against the cached global
    scale; a few keep the shadow (refreshed in place, counted), past
    max(64, 1% of the live rows) the next search rebuilds it with a new
    scale."""
    arrays, base, queries = trained
    port = hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(
        num_subspaces=8, search_mode="scan_pallas_int8",
        int8_epilogue="global"), device="cpu")
    port.load_state_arrays(arrays)
    q = torch.from_numpy(queries[:4])
    port.search_batch(q, K)
    shadow = port._caches.scan8g.value  # (..., sv, ..., clipped)
    sv0 = float(shadow[2])
    r = np.random.default_rng(19)
    wide = lambda m: (r.standard_normal((m, D)) * 20.0).astype(np.float32)
    port.add_batch(range(20_000, 20_010), wide(10))
    port.search_batch(q, K)
    value = port._caches.scan8g.value
    assert value[0] is shadow[0]  # refreshed in place
    assert value[-1] == 10 and float(value[2]) == sv0
    port.add_batch(range(20_010, 20_070), wide(60))
    ids, _ = port.search_batch(wide(1), K)
    value = port._caches.scan8g.value
    assert value[-1] == 0 and float(value[2]) > sv0
    assert value[0] is not shadow[0]


def test_compressed_fused_adc_matches_reference():
    """adc_fast with adc_pool="fused" on the compressed store with the
    residual level (the int8 refine), streamed by the reference."""
    r = np.random.default_rng(20)
    vecs = (r.standard_normal((4000, D)) * (np.arange(D) + 1.0) ** -0.5
            ).astype(np.float32)
    cfg = dict(raw_store=False, refine_residual=True, num_subspaces=8,
               training_samples=1500, search_mode="adc_fast",
               adc_pool="fused", adc_select_r=128)
    ref = ref_hp.HnswPqIndex(D, CAP, "l2", RefConfig(**cfg))
    ref.bulk_load_stream([(range(s, s + 2000), vecs[s:s + 2000])
                          for s in range(0, 4000, 2000)])
    port = hp.HnswPqIndex(D, CAP, "l2", HnswPqConfig(**cfg), device="cpu")
    port.load_state_arrays(ref.state_arrays())
    queries = (r.standard_normal((32, D)) * (np.arange(D) + 1.0) ** -0.5
               ).astype(np.float32)
    ref_ids, _ = ref.search_batch(queries, K)
    port_ids, _ = port.search_batch(torch.from_numpy(queries), K)
    gt = _oracle(dict(enumerate(vecs)), queries)
    assert _overlap(port_ids, ref_ids) >= 0.99
    assert _overlap(port_ids, gt) >= _overlap(ref_ids, gt) - 0.005
