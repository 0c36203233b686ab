"""Rows of any width: the port's s8 pool kernels' plain versions and the
index modes built on the pools against the reference at 1536 dims, past the
1040 where one f32 matmul of int8 values stops being exact, on the CPU; the
reference's Pallas kernels run in interpret mode.  (The bf16 pools' plain
versions at 768 dims are in test_torch_fused_scans.py.)

Tolerances are those of the d <= 512 parity tests: B2 and B4 slots equal,
values within rtol 1e-6 + atol 1e-6 * max|vals| (XLA-CPU may fuse the f32
epilogue into an FMA); B7 bit-equal; B8 within two ulps (XLA-CPU fuses its
``off + cross * sc``) with equal positions; searches: mean top-10 overlap
with the reference >= 0.99 and recall against an exact oracle no lower
than the reference's minus 0.005.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from vector_db_tpu.api.config import HnswPqConfig as RefConfig  # noqa: E402
from vector_db_tpu.index import hnsw_pq as ref_hp  # noqa: E402
from vector_db_tpu.ops import pallas_kernels as ref_pk  # noqa: E402
from vector_db_tpu.ops.distance import pack_int8_rows as ref_pack  # noqa: E402
from vector_db_torch.api.config import HnswPqConfig  # noqa: E402
from vector_db_torch.index import hnsw_pq as hp  # noqa: E402
from vector_db_torch.ops import kernels as tk  # noqa: E402

WIDE = 1536
K = 10


def _t(x):
    return torch.from_numpy(np.array(x))


def _corpus(n, d, dead, seed, offset=1.0):
    r = np.random.default_rng(seed)
    base = (r.standard_normal((n, d)) + offset).astype(np.float32)
    valid = np.ones(n, bool)
    valid[r.choice(n, int(dead * n), replace=False)] = False
    return base, (base * base).sum(1), valid, r


def _close_pool(tv, ts, jv, js):
    jv, js = np.asarray(jv), np.asarray(js)
    tv, ts = tv.numpy(), ts.numpy()
    assert tv.shape == jv.shape
    np.testing.assert_array_equal(ts, js)
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    scale = np.abs(jv[fin]).max()
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=1e-6, atol=1e-6 * scale)


# ------------------------------------------------------------ the s8 cross
@pytest.mark.parametrize("a_shape,b_shape", [((3, WIDE), (4, WIDE)),
                                             ((2, 3, 2100), (2, 5, 2100))])
def test_int8_cross_is_exact_past_2_24(a_shape, b_shape):
    """Sums of int8 products past 2^24 (where f32 keeps only even integers)
    equal the int64 product; one f32 matmul would round them."""
    r = np.random.default_rng(len(a_shape))
    a = np.full(a_shape, 127, np.int8)
    b = np.full(b_shape, 127, np.int8)
    a[..., 0] = r.integers(100, 127, a_shape[:-1])  # odd sums past 2^24
    b[..., 1] = -r.integers(1, 127, b_shape[:-1])
    want = np.einsum("...md,...nd->...mn", a.astype(np.int64),
                     b.astype(np.int64))
    assert np.abs(want).max() >= 2 ** 24 and (want % 2 == 1).any()
    got = tk.int8_cross(_t(a), _t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    f32 = _t(a).to(torch.float32) @ _t(b).to(torch.float32).transpose(-1, -2)
    assert not np.array_equal(f32.numpy().astype(np.int64), want)


# ------------------------------------------------------ the s8 pools (B2/B4/B7)
def test_int8_pool_plain_matches_reference_wide():
    """B2 at d = 1536, Q = 8, N = 2048, w = 256."""
    base, norms, valid, r = _corpus(2048, WIDE, 0.1, seed=61)
    base8, off, sc, cvec, _ = ref_hp._build_scan8_shadow(
        jnp.asarray(base), jnp.asarray(norms), jnp.asarray(valid), "l2", 1)
    qc = (r.standard_normal((8, WIDE)) + 1.0).astype(np.float32) - np.asarray(
        cvec)[None, :]
    jv, js = ref_pk.fused_int8_pool(jnp.asarray(qc), base8, off, sc, 256,
                                    interpret=True)
    tv, ts = tk.fused_int8_pool(_t(qc), _t(base8), _t(off), _t(sc), 256)
    _close_pool(tv, ts, jv, js)


def test_packed_pool_plain_matches_reference_wide():
    """B4 at d = 1536 over the reference's packed words."""
    base, norms, valid, r = _corpus(4096, WIDE, 0.2, seed=62)
    b = jnp.asarray(base)
    packed, scales = ref_pack(b)
    off, sc, cvec = ref_hp._build_scan8p_shadow(
        packed, scales, jnp.asarray(norms), jnp.asarray(valid), "l2")
    qc = (r.standard_normal((5, WIDE)) + 1.0).astype(np.float32) - np.asarray(
        cvec)[None, :]
    jv, js = ref_pk.fused_packed_pool(jnp.asarray(qc), packed, off, sc, 2048,
                                      interpret=True)
    tv, ts = tk.fused_packed_pool(_t(qc), _t(packed), _t(off), _t(sc), 2048)
    _close_pool(tv, ts, jv, js)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_int8g_pool_plain_bit_equal_to_reference_wide(metric):
    """B7 at d = 1536: integer pool, bit-equal."""
    base, norms, valid, r = _corpus(3000, WIDE, 0.1, seed=63)
    out = ref_hp._build_scan8g_shadow(jnp.asarray(base), jnp.asarray(norms),
                                      jnp.asarray(valid), metric, 1)
    base8, off, sv, sgn, cvec, _ = out
    q = (r.standard_normal((6, WIDE)) + 1.0).astype(np.float32)
    if metric == "cosine":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    qc = q - np.asarray(cvec)[None, :]
    jv, js = ref_pk.fused_int8g_pool(jnp.asarray(qc), base8, off, sv,
                                     float(sgn), 512, interpret=True)
    tv, ts = tk.fused_int8g_pool(_t(qc), _t(base8), _t(off), _t(sv),
                                 float(sgn), 512)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ------------------------------------------------------------------ B8
def test_ivf_pool_plain_matches_reference_wide():
    """B8 at d = 1536: two ulps, equal positions on the rows a merge reads."""
    nlist, cap, p_cap, winners = 4, 256, 16, 2
    rng = np.random.default_rng(64)
    v8 = rng.integers(-127, 128, (nlist * cap, WIDE), dtype=np.int8)
    q8 = rng.integers(-127, 128, (nlist * p_cap, WIDE), dtype=np.int8)
    off = (rng.normal(size=nlist * cap) * 1e6).astype(np.float32)
    sc = -rng.uniform(0.01, 0.05, nlist * cap).astype(np.float32)
    off[rng.uniform(size=nlist * cap) < 0.1] = np.inf
    counts = np.array([p_cap, 0, 5, 11], np.int32)
    qsel, cm = q8.view(np.int32), v8.view(np.int32)
    cids = np.flatnonzero(counts > 0).astype(np.int32)
    jv, jp = ref_pk.fused_ivf_pool(jnp.asarray(cids), jnp.asarray(qsel),
                                   jnp.asarray(cm), jnp.asarray(off),
                                   jnp.asarray(sc), nlist, cap, p_cap,
                                   winners, interpret=True)
    tv, tp = tk.fused_ivf_pool(_t(counts), _t(qsel), _t(cm), _t(off), _t(sc),
                               nlist, cap, p_cap, winners)
    read = np.concatenate([c * p_cap + np.arange(counts[c]) for c in cids])
    jv, jp = np.asarray(jv)[read], np.asarray(jp)[read]
    tv, tp = tv.numpy()[read], tp.numpy()[read]
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    ulp = np.spacing(np.abs(jv[fin]).astype(np.float32))
    assert (np.abs(tv[fin] - jv[fin]) <= 2 * ulp).all()
    np.testing.assert_array_equal(tp[fin], jp[fin])


# ------------------------------------------------------------------ index
def _overlap(a, b):
    return float(np.mean([len(set(x) & set(y)) / K for x, y in zip(a, b)]))


def _oracle(x, queries):
    d = ((queries.astype(np.float64)[:, None, :]
          - x.astype(np.float64)[None]) ** 2).sum(-1)
    return np.argsort(d, axis=1)[:, :K]


@pytest.fixture(scope="module")
def wide_data():
    """A 1536-d mixture: 4,000 rows around 40 centres, 16 queries."""
    r = np.random.default_rng(67)
    centers = r.standard_normal((40, WIDE)).astype(np.float32) * 3.0
    x = (centers[r.integers(0, 40, 4000)]
         + r.standard_normal((4000, WIDE))).astype(np.float32)
    q = (centers[r.integers(0, 40, 16)]
         + r.standard_normal((16, WIDE))).astype(np.float32)
    return x, q


@pytest.mark.parametrize("mode,extra", [
    ("scan_pallas_int8", {}),
    ("scan_pallas_int8", {"int8_epilogue": "global"}),
    ("scan_ivf", {"nprobe": 6}),
    ("scan_pallas", {}),
    ("adc_fast", {"adc_pool": "fused"}),
], ids=["int8_per_row", "int8_global", "scan_ivf", "scan_pallas",
        "adc_fused"])
def test_wide_index_modes_match_reference(wide_data, mode, extra):
    """scan_pallas_int8 (both epilogues), scan_ivf, scan_pallas and
    adc_fast with the fused pool through HnswPqIndex at d = 1536, the port
    loaded from the reference's trained state."""
    x, q = wide_data
    cfg = dict(search_mode=mode, num_subspaces=8, training_samples=1500,
               **extra)
    ref = ref_hp.HnswPqIndex(WIDE, 4096, "l2", RefConfig(**cfg))
    ref.bulk_load(list(range(len(x))), x)
    port = hp.HnswPqIndex(WIDE, 4096, "l2", HnswPqConfig(**cfg),
                          device="cpu")
    port.config.nlist = ref.config.nlist
    port.load_state_arrays(ref.state_arrays())
    ref_ids, _ = ref.search_batch(q, K)
    port_ids, port_d = port.search_batch(torch.from_numpy(q), K)
    gt = _oracle(x, q)
    assert _overlap(port_ids, ref_ids) >= 0.99
    assert _overlap(port_ids, gt) >= _overlap(ref_ids, gt) - 0.005
    assert np.all(np.diff(port_d, axis=1) >= 0)
