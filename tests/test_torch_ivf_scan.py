"""The port's cluster-pruned tier (search_mode="scan_ivf") and its two
kernels' plain versions against the reference, on the CPU: the layout
functions of ``ops/ivf_scan``, ``fused_ivf_pool`` (B8) and
``fused_scan_topk`` (B1) against the Pallas kernels in interpret mode, the
candidate stage, the coarse quantizer, and HnswPqIndex in scan_ivf on both
stores with the reference's state carried across by ``load_state_arrays``.

Tolerances: the layout, inversion and geometry functions are integer
bookkeeping and equal exactly.  B8's cross term is exact and its epilogue
rounds the product and the sum apart, as the TPU kernel does and the CUDA
kernel does bit for bit; XLA's CPU backend, which runs the reference here,
fuses them into one multiply-add, so on the CPU the values agree within
one ulp, and the positions exactly where the value is finite, on the rows
the merge reads.
B1 sums f32 in another order than XLA: ``ops/kernels.check_scan_topk``
(ids agree in >= 99.9% of entries, each distance within 2 (D + 2) 2^-24
times the sum of its terms' magnitudes, plus one ulp of the final add, of
the float64 distance).  Candidates: the selection values equal, the slots
equal up to the order of tied values.  Searches: mean top-10 overlap with
the reference >= 0.99 and recall against an exact oracle no lower than the
reference's minus 0.005.  k-means: the blocked Lloyd within 2e-3 of the
dense one (f32 sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from vector_db_tpu.api.config import HnswPqConfig as RefConfig  # noqa: E402
from vector_db_tpu.index import hnsw_pq as ref_hp  # noqa: E402
from vector_db_tpu.index.base import pad_queries_pow2 as ref_pad  # noqa: E402
from vector_db_tpu.ops import ivf_scan as ref_ivf  # noqa: E402
from vector_db_tpu.ops import pallas_kernels as ref_pk  # noqa: E402
from vector_db_torch.api.config import HnswPqConfig  # noqa: E402
from vector_db_torch.index import hnsw_pq as hp  # noqa: E402
from vector_db_torch.index.base import pad_queries_pow2  # noqa: E402
from vector_db_torch.ops import ivf_scan  # noqa: E402
from vector_db_torch.ops import kernels as tk  # noqa: E402
from vector_db_torch.ops import kmeans as tkm  # noqa: E402

K = 10


def _t(x):
    return torch.from_numpy(np.array(x))


def _mixture(rng, n, d, modes=40, scale=3.0):
    centers = rng.normal(size=(modes, d)).astype(np.float32) * scale
    return (centers[rng.integers(0, modes, n)]
            + rng.normal(size=(n, d)).astype(np.float32)), centers


def _overlap(a, b):
    return float(np.mean([len(set(x[:K]) & set(y[:K])) / K
                          for x, y in zip(a, b)]))


def _oracle(rows: dict, queries, metric="l2"):
    ids = np.asarray(sorted(rows))
    mat = np.stack([rows[i] for i in ids]).astype(np.float64)
    q = queries.astype(np.float64)
    if metric == "cosine":
        mat = mat / np.linalg.norm(mat, axis=1, keepdims=True)
        d = -(q / np.linalg.norm(q, axis=1, keepdims=True)) @ mat.T
    else:
        d = (q * q).sum(1)[:, None] + (mat * mat).sum(1)[None] - 2 * q @ mat.T
    return ids[np.argsort(d, axis=1)[:, :K]]


def _assert_ulp_close(got, want):
    """Equal infinities, finite values within two ulps of the largest
    finite score: XLA's CPU backend contracts the reference's ``off + cross
    * sc`` into one fused multiply-add, where the port (and the kernel on
    the card) rounds the product and the sum apart, as the TPU kernel's two
    operations do; each rounding is at most half an ulp of a value no
    larger than the largest score."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isinf(want)], want[np.isinf(want)])
    fin = np.isfinite(want)
    gap = np.abs(got[fin].astype(np.float64) - want[fin])
    assert gap.max(initial=0.0) <= 2 * np.spacing(np.abs(want[fin]).max())


def _pack(a):
    """int8 [n, d] -> int32 words [n, d/4] (the packed stores' layout)."""
    return np.ascontiguousarray(a).view(np.int32)


# ------------------------------------------------------------ bookkeeping
@pytest.mark.parametrize("nlist,p_cap,q_n,nprobe", [
    (13, 4, 9, 5),      # tiles overflow: some probes are dropped
    (7, 64, 20, 7),     # every cluster probed by every query
    (300, 32, 3, 8),    # most clusters unprobed
])
def test_invert_probers_matches_reference(nlist, p_cap, q_n, nprobe):
    rng = np.random.default_rng(nlist + q_n)
    top_c = np.stack([rng.choice(nlist, nprobe, replace=False)
                      for _ in range(q_n)]).astype(np.int32)
    jp, jq = ref_ivf.invert_probers(jnp.asarray(top_c), nlist, p_cap)
    tp, tq = ivf_scan.invert_probers(_t(top_c).long(), nlist, p_cap)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("nlist,q_n,nprobe,p_cap", [
    (13, 9, 5, 4), (7, 20, 7, 64), (300, 3, 8, 32), (64, 1, 16, 32)])
def test_prober_counts_stand_in_for_the_reference_worklist(nlist, q_n,
                                                           nprobe, p_cap):
    """The port's [nlist] prober counts mark exactly the clusters of the
    reference's worklist (whose pads repeat cluster 0), and each count is
    the occupancy of the cluster's prober tile in ``invert_probers``."""
    rng = np.random.default_rng(nlist * q_n)
    top_c = np.stack([rng.choice(nlist, nprobe, replace=False)
                      for _ in range(q_n)]).astype(np.int32)
    work = np.asarray(ref_ivf._unique_worklist(jnp.asarray(top_c), nlist))
    counts = ivf_scan.prober_counts(_t(top_c), nlist, p_cap).numpy()
    probed = set(np.flatnonzero(counts > 0).tolist())
    assert probed == set(np.unique(top_c).tolist())
    assert probed <= set(work.tolist()) <= probed | {0}
    _, ppos = ref_ivf.invert_probers(jnp.asarray(top_c), nlist, p_cap)
    kept = np.bincount(top_c[np.asarray(ppos) >= 0], minlength=nlist)
    np.testing.assert_array_equal(counts, kept)


@pytest.mark.parametrize("m,nlist,cap,a_n,dead,prefer0", [
    (5000, 8, 768, 4, 17, False),   # uniform choices, every 17th slot dead
    (300, 4, 128, 1, 0, True),      # all prefer cluster 0: the rest spill
    (3000, 16, 256, 3, 5, True),    # skewed: spills past three choices
])
def test_balanced_layouts_match_reference(m, nlist, cap, a_n, dead, prefer0):
    rng = np.random.default_rng(m + nlist)
    choices = rng.integers(0, nlist, (m, a_n)).astype(np.int32)
    if prefer0:
        choices[:, 0] = 0
    valid = np.ones(m, bool)
    if dead:
        valid[::dead] = False
    live = np.flatnonzero(valid)
    hp2s, hspill = ref_ivf.build_balanced_layout(choices[valid], live, nlist,
                                                 cap)
    jp, js, jn = ref_ivf.balanced_layout_dev(jnp.asarray(choices),
                                             jnp.asarray(valid), nlist, cap)
    tp, ts, tn = ivf_scan.balanced_layout_dev(_t(choices), _t(valid), nlist,
                                              cap)
    np.testing.assert_array_equal(tp.numpy(), hp2s)
    assert int(tn) == hspill
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tn) == int(jn)
    if prefer0:
        assert int(tn) > 0  # the spill case is exercised
    placed = tp.numpy()[tp.numpy() >= 0]
    assert sorted(placed) == sorted(live)


def test_auto_ivf_geometry_matches_reference():
    for n in (1000, 20_000, 100_000, 1_048_576, 1_050_624, 10_000_000):
        for w in (1, 2, 4):
            for nlist in (0, 16, 513):
                got = ivf_scan.auto_ivf_geometry(n, nlist, winners=w)
                assert got == ref_ivf.auto_ivf_geometry(n, nlist, winners=w)
                nl, cap = got
                assert cap % tk.LANES == 0 and w * cap // tk.LANES <= 128
                assert nl * cap >= n + nl


@pytest.mark.parametrize("metric,packed", [("l2", False), ("cosine", False),
                                           ("l2", True), ("cosine", True)])
def test_coarse_choices_match_reference(metric, packed):
    rng = np.random.default_rng(31)
    x, _ = _mixture(rng, 2048, 32)
    cents = rng.normal(size=(24, 32)).astype(np.float32) * 3.0
    if packed:
        scales = np.maximum(np.abs(x).max(1), 1e-30) / 127.0
        x8 = np.clip(np.round(x / scales[:, None]), -127, 127).astype(np.int8)
        src, sc = _pack(x8), scales.astype(np.float32)
        want = ref_ivf.coarse_choices(jnp.asarray(src), jnp.asarray(sc),
                                      jnp.asarray(cents), metric, 8, 512,
                                      approx=False)
        got = ivf_scan.coarse_choices(_t(src), _t(sc), _t(cents), metric, 8,
                                      500)
    else:
        want = ref_ivf.coarse_choices(jnp.asarray(x), None, jnp.asarray(cents),
                                      metric, 8, 512, approx=False)
        got = ivf_scan.coarse_choices(_t(x), None, _t(cents), metric, 8, 500)
        rows = x
    got, want = got.numpy(), np.asarray(want)
    # equal but where two centroids lie within f32 rounding of each other
    # (the two products sum in other orders): then their distances agree
    if packed:
        rows = x8.astype(np.float64) * scales[:, None]
    rows = rows.astype(np.float64)
    if metric == "cosine":
        rows = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    cd = (cents.astype(np.float64) ** 2).sum(1)[None] - 2 * rows @ cents.T
    diff = got != want
    assert diff.mean() <= 1e-3
    r = np.nonzero(diff)[0]
    gap = np.abs(cd[r, got[diff]] - cd[r, want[diff]])
    assert (gap <= 1e-5 * np.abs(cd).max()).all()


# ------------------------------------------------------- fused_ivf_pool (B8)
def _ivf_case(seed, nlist, cap, p_cap, d, winners, narrow=False):
    """Random int8 rows and probers, +inf offsets at pads and dead rows,
    some clusters unprobed and some prober tiles partly filled.  With
    ``narrow`` the values are small integers, so scores tie often."""
    rng = np.random.default_rng(seed)
    lo, hi = (-2, 3) if narrow else (-127, 128)
    v8 = rng.integers(lo, hi, (nlist * cap, d), dtype=np.int8)
    q8 = rng.integers(lo, hi, (nlist * p_cap, d), dtype=np.int8)
    if narrow:
        off = rng.integers(0, 4, nlist * cap).astype(np.float32)
        sc = np.ones(nlist * cap, np.float32)
    else:
        off = rng.normal(size=nlist * cap).astype(np.float32) * 50.0
        sc = -rng.uniform(0.01, 0.05, nlist * cap).astype(np.float32)
    off[rng.uniform(size=nlist * cap) < 0.1] = np.inf   # dead rows
    off[cap - 5:cap] = np.inf                           # a pad tail
    off[2 * cap:2 * cap + tk.LANES] = np.inf            # an all-dead bucket
    counts = rng.integers(1, p_cap + 1, nlist).astype(np.int32)
    counts[rng.uniform(size=nlist) < 0.3] = 0           # unprobed clusters
    counts[0] = p_cap
    return _pack(q8), _pack(v8), off, sc, counts



def _hold_ivf_to_reference(seed, nlist, cap, p_cap, d, winners, narrow,
                           **wrapper_args):
    """``fused_ivf_pool`` on CPU tensors (its plain version) against the
    reference kernel in interpret mode on the rows a merge reads; returns
    the port's (vals, pos) of those rows and the tensors the call gave."""
    qsel, cm, off, sc, counts = _ivf_case(seed, nlist, cap, p_cap, d, winners,
                                          narrow)
    cids = np.flatnonzero(counts > 0).astype(np.int32)
    jv, jp = ref_pk.fused_ivf_pool(jnp.asarray(cids), jnp.asarray(qsel),
                                   jnp.asarray(cm), jnp.asarray(off),
                                   jnp.asarray(sc), nlist, cap, p_cap,
                                   winners, interpret=True)
    got = tk.fused_ivf_pool(_t(counts), _t(qsel), _t(cm), _t(off), _t(sc),
                            nlist, cap, p_cap, winners, **wrapper_args)
    assert tuple(got[0].shape) == np.asarray(jv).shape == (nlist * p_cap, 128)
    read = np.concatenate([c * p_cap + np.arange(counts[c]) for c in cids])
    jv, jp = np.asarray(jv)[read], np.asarray(jp)[read]
    tv, tp = got[0].numpy()[read], got[1].numpy()[read]
    _assert_ulp_close(tv, jv)
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(tp[fin], jp[fin])
    used = winners * cap // 128
    assert (tp[:, used:] == -1).all() and np.isinf(tv[:, used:]).all()
    lane = tp[:, :used] - ((read // p_cap) * cap)[:, None]
    assert ((0 <= lane) & (lane < cap))[fin[:, :used]].all()
    return tv, tp, got


@pytest.mark.parametrize("nlist,cap,p_cap,d,winners,narrow", [
    (5, 256, 8, 16, 2, False),
    (4, 384, 32, 32, 4, False),
    (6, 1024, 16, 16, 1, False),
    (3, 512, 8, 8, 4, True),      # ties within buckets
    (4, 256, 70, 12, 2, True),    # p_cap past one 64-row tile, ties
])
def test_ivf_pool_plain_bit_equal_to_reference(nlist, cap, p_cap, d, winners,
                                               narrow):
    tv, _, _ = _hold_ivf_to_reference(nlist * cap + d, nlist, cap, p_cap, d,
                                      winners, narrow)
    if narrow:  # tied winners within a bucket occur (lowest lane first)
        bpb = cap // 128
        assert (tv[:, :bpb] == tv[:, bpb:2 * bpb]).any()


@pytest.mark.parametrize("nlist,cap,p_cap,d,winners,narrow", [
    (5, 640, 32, 16, 4, False),   # p_cap 32, prober counts that end mid-tile
    (5, 640, 32, 16, 4, True),    # ... with ties
    (6, 128, 16, 16, 4, False),   # one bucket a cluster
    (4, 128, 8, 8, 8, True),      # ... eight winners of it, ties
    (3, 4096, 8, 8, 4, False),    # the pool row full: 4 x 32 buckets = 128
])
def test_ivf_pool_plain_bit_equal_to_reference_at_the_edges(
        nlist, cap, p_cap, d, winners, narrow):
    """The shapes at the kernel's edges: the smallest prober tile with
    ragged counts, a single bucket, and a pool row with no unused column;
    the caller's probe count and output buffers change nothing."""
    out = (torch.full((nlist * p_cap, 128), -5.0),
           torch.full((nlist * p_cap, 128), -7, dtype=torch.int32))
    _, _, got = _hold_ivf_to_reference(
        7 * nlist + cap + winners, nlist, cap, p_cap, d, winners, narrow,
        probes=nlist * p_cap, out=out)
    assert got[0] is out[0] and got[1] is out[1]


def test_ivf_pool_rejects_a_cap_the_pool_row_cannot_hold():
    qsel, cm, off, sc, counts = _ivf_case(1, 2, 256, 8, 16, 1)
    with pytest.raises(ValueError, match="multiple of 128"):
        tk.fused_ivf_pool(_t(counts), _t(qsel), _t(cm), _t(off), _t(sc),
                          2, 256, 8, winners=65)


def test_ivf_pool_rejects_a_strided_grid():
    """A column slice of a wider grid would be read as dense rows."""
    qsel, cm, off, sc, counts = _ivf_case(2, 2, 256, 8, 16, 1)
    wide = _t(np.concatenate([cm, cm], axis=1))
    with pytest.raises(ValueError, match="cm must be contiguous"):
        tk.fused_ivf_pool(_t(counts), _t(qsel), wide[:, :cm.shape[1]],
                          _t(off), _t(sc), 2, 256, 8, winners=1)


# ------------------------------------------------------------- candidates
def _layout(x, nlist_hint=0, metric="l2", seed=43):
    """A reference-built layout of corpus x (per-row int8 rows uncentered,
    L2 conditioning): (cents, cm, off, sc, pos2slot) as numpy arrays."""
    from vector_db_tpu.ops.kmeans import kmeans_fit

    n, d = x.shape
    nlist, cap = ref_ivf.auto_ivf_geometry(n, nlist_hint)
    cents, _ = kmeans_fit(jax.random.PRNGKey(seed), jnp.asarray(x), k=nlist,
                          iters=6)
    choices = ref_ivf.coarse_choices(jnp.asarray(x), None, cents, metric, 8,
                                     n // 4, approx=False)
    p2s, _, _ = ref_ivf.balanced_layout_dev(choices, jnp.ones(n, bool),
                                            nlist, cap)
    p2s = np.asarray(p2s)
    scale = np.maximum(np.abs(x).max(1), 1e-30) / 127.0
    x8 = np.clip(np.round(x / scale[:, None]), -127, 127).astype(np.int8)
    safe, live = np.maximum(p2s, 0), p2s >= 0
    off = np.where(live, (x ** 2).sum(1)[safe], np.inf).astype(np.float32)
    sc = np.where(live, -2.0 * scale[safe], 0.0).astype(np.float32)
    return np.asarray(cents), _pack(x8)[safe], off, sc, p2s


@pytest.mark.parametrize("q_n,nprobe,p_cap", [(1, 8, 32), (16, 6, 64),
                                              (8, 30, 32)])
def test_ivf_candidates_match_reference(q_n, nprobe, p_cap):
    rng = np.random.default_rng(4 + q_n)
    x, centers = _mixture(rng, 6000, 32)
    cents, cm, off, sc, p2s = _layout(x)
    q = (centers[rng.integers(0, 40, q_n)]
         + rng.normal(size=(q_n, 32))).astype(np.float32)
    cvec = np.zeros(32, np.float32)  # the layout's rows are uncentered
    jv, js = ref_ivf.ivf_pool_candidates(
        jnp.asarray(q), jnp.asarray(cents), jnp.asarray(cm), jnp.asarray(off),
        jnp.asarray(sc), jnp.asarray(cvec), jnp.asarray(p2s), "l2",
        nprobe=nprobe, p_cap=p_cap, pool=128, winners=4)
    tv, ts = ivf_scan.ivf_pool_candidates(
        _t(q), _t(cents), _t(cm), _t(off), _t(sc), _t(cvec), _t(p2s), "l2",
        nprobe=nprobe, p_cap=p_cap, pool=128, winners=4)
    jv, js = np.asarray(jv), np.asarray(js)
    _assert_ulp_close(tv.numpy(), jv)
    # the same slots, but where values within an ulp swap places
    same = [len(set(a) & set(b)) for a, b in zip(ts.numpy(), js)]
    assert sum(same) >= 0.99 * js.size
    true = _oracle(dict(enumerate(x)), q)
    contained = np.mean([len(set(t) & set(c)) / K
                         for t, c in zip(true, ts.numpy())])
    assert contained >= 0.9


@pytest.mark.parametrize("q_n", [1, 5])
def test_query_scale_covers_the_padded_batch(q_n):
    """The int8 query scale is one scale over the pow2-padded batch the
    index hands in, whose zero rows center to -cvec (the reference's
    quirk, kept): the candidates equal the reference's on the padded batch
    and differ from those of the real rows quantized alone."""
    rng = np.random.default_rng(60 + q_n)
    x, centers = _mixture(rng, 6000, 32)
    cents, cm, off, sc, p2s = _layout(x)
    cvec = (x[:64].mean(0) + 4.0).astype(np.float32)
    # queries near cvec: the pad rows (-cvec once centered) are the widest
    raw = (cvec + rng.normal(size=(q_n, 32)) * 0.3).astype(np.float32)
    padded_j, _ = ref_pad(raw)
    padded_t, _ = pad_queries_pow2(_t(raw))
    np.testing.assert_array_equal(padded_t.numpy(), np.asarray(padded_j))
    qc = padded_t.numpy() - cvec[None, :]
    assert np.abs(qc).max() > np.abs(qc[:q_n]).max()  # the pads widen sq
    args = ("l2", 8, 32, 64, 4)
    jv, _ = ref_ivf.ivf_pool_candidates(
        jnp.asarray(padded_j), jnp.asarray(cents), jnp.asarray(cm),
        jnp.asarray(off), jnp.asarray(sc), jnp.asarray(cvec),
        jnp.asarray(p2s), *args)
    tv, _ = ivf_scan.ivf_pool_candidates(
        padded_t, _t(cents), _t(cm), _t(off), _t(sc), _t(cvec), _t(p2s),
        *args)
    _assert_ulp_close(tv.numpy(), np.asarray(jv))
    alone, _ = ivf_scan.ivf_pool_candidates(
        _t(raw), _t(cents), _t(cm), _t(off), _t(sc), _t(cvec), _t(p2s),
        *args)
    assert not torch.equal(alone, tv[:q_n])


# ------------------------------------------------------------------ index
def _corpus(seed, n, d, modes=40):
    rng = np.random.default_rng(seed)
    x, centers = _mixture(rng, n, d, modes)
    q = (centers[rng.integers(0, modes, 24)]
         + rng.normal(size=(24, d))).astype(np.float32)
    return x, q, rng


def _pair(x, cfg, cap, metric="l2", stream=False):
    """A reference index built on x and the port loaded from its state."""
    ref = ref_hp.HnswPqIndex(x.shape[1], cap, metric, RefConfig(**cfg))
    if stream:
        ref.bulk_load_stream([(range(s, s + 3000), x[s:s + 3000])
                              for s in range(0, len(x), 3000)])
    else:
        ref.bulk_load(list(range(len(x))), x)
    port = hp.HnswPqIndex(x.shape[1], cap, metric, HnswPqConfig(**cfg),
                          device="cpu")
    port.config.nlist = ref.config.nlist
    port.load_state_arrays(ref.state_arrays())
    return ref, port


@pytest.mark.parametrize("raw", [True, False], ids=["raw", "compressed"])
def test_scan_ivf_index_matches_reference(raw):
    x, q, _ = _corpus(5, 9000, 32)
    cfg = dict(search_mode="scan_ivf", nprobe=6, raw_store=raw,
               num_subspaces=8, training_samples=2000,
               refine_residual=not raw)
    ref, port = _pair(x, cfg, 10_000, stream=not raw)
    assert ref.config.nlist > 0 and port.coarse_centroids is not None
    ref_ids, _ = ref.search_batch(q, K)
    port_ids, port_d = port.search_batch(torch.from_numpy(q), K)
    gt = _oracle(dict(enumerate(x)), q)
    assert _overlap(port_ids, ref_ids) >= 0.99
    assert _overlap(port_ids, gt) >= _overlap(ref_ids, gt) - 0.005
    assert np.all(np.diff(port_d, axis=1) >= 0)
    lay = port._caches.ivf.value
    ref_lay = ref._ivf_cache[2]
    assert lay.cap == ref_lay.cap and lay.spilled == ref_lay.spilled
    np.testing.assert_array_equal(lay.pos2slot.numpy(),
                                  np.asarray(ref_lay.pos2slot))


def test_scan_ivf_crud_overlay_and_relayout_match_reference():
    x, q, rng = _corpus(6, 8000, 32, modes=20)
    cfg = dict(search_mode="scan_ivf", nprobe=8, num_subspaces=8,
               training_samples=2000)
    ref, port = _pair(x, cfg, 12_000)
    rows = dict(enumerate(x))

    def check():
        ref_ids, _ = ref.search_batch(q, K)
        port_ids, _ = port.search_batch(torch.from_numpy(q), K)
        assert _overlap(port_ids, ref_ids) >= 0.99
        gt = _oracle(rows, q)
        assert _overlap(port_ids, gt) >= _overlap(ref_ids, gt) - 0.005
        return port_ids

    check()
    # adds after the layout land in the exact overlay, not the grid
    xa = _mixture(rng, 300, 32, modes=20)[0]
    ids_a = list(range(8000, 8300))
    assert port.add_batch(ids_a, xa) == ref.add_batch(ids_a, xa)
    rows.update(zip(ids_a, xa))
    ids = check()
    assert port._caches.ivf.value.overlay.size == ref._ivf_overlay.size == 300
    # removing a returned neighbour takes effect at once
    victim = int(ids[0, 0])
    assert port.remove(victim) and ref.remove(victim)
    del rows[victim]
    assert victim not in port.search_batch(torch.from_numpy(q[:1]), K)[0][0]
    assert port.coarse_assign[port.store.slot_of(8000)] == \
        ref.coarse_assign[ref.store.slot_of(8000)]
    # crossing the overlay budget lays the grid out again on the next search
    port._IVF_OVERLAY_MAX = ref._IVF_OVERLAY_MAX = 64
    xb = _mixture(rng, 200, 32, modes=20)[0]
    ids_b = list(range(8300, 8500))
    assert port.add_batch(ids_b, xb) == ref.add_batch(ids_b, xb)
    rows.update(zip(ids_b, xb))
    check()
    assert port._caches.ivf.value.overlay.size == ref._ivf_overlay.size == 0
    assert port._caches.ivf.key == port.store.version


def test_scan_ivf_checkpoints_cross_both_ways():
    """The reference's state (coarse centroids and assignment included)
    loads into the port, and the port's own trained state loads into the
    reference: each pair answers alike."""
    x, q, _ = _corpus(7, 6000, 32, modes=16)
    cfg = dict(search_mode="scan_ivf", nprobe=6, num_subspaces=8,
               training_samples=2000)
    ref, port = _pair(x, cfg, 6500)
    np.testing.assert_array_equal(port.coarse_assign, ref.coarse_assign)
    ref_ids, _ = ref.search_batch(q, K)
    assert _overlap(port.search_batch(torch.from_numpy(q), K)[0],
                    ref_ids) >= 0.99
    own = hp.HnswPqIndex(32, 6500, "l2", HnswPqConfig(**cfg), device="cpu")
    own.bulk_load(list(range(len(x))), x)
    state = own.state_arrays()
    assert state["coarse_centroids"].shape == (own.config.nlist, 32)
    back = ref_hp.HnswPqIndex(32, 6500, "l2", RefConfig(**cfg))
    back.config.nlist = own.config.nlist
    # the port allocates no graph (use_graph=False): the reference's loader
    # takes its own empty one
    back.load_state_arrays({**state, "graph": back.state_arrays()["graph"]})
    own_ids, _ = own.search_batch(torch.from_numpy(q), K)
    assert _overlap(own_ids, back.search_batch(q, K)[0]) >= 0.99
    gt = _oracle(dict(enumerate(x)), q)
    assert _overlap(own_ids, gt) >= 0.95


def test_scan_ivf_cosine_matches_reference():
    x, q, _ = _corpus(8, 8000, 32, modes=20)
    x, q = x + 2.0, q + 2.0  # an offset corpus: cosine != l2
    cfg = dict(search_mode="scan_ivf", nprobe=8, num_subspaces=8,
               training_samples=2000)
    ref, port = _pair(x, cfg, 8500, metric="cosine")
    ref_ids, _ = ref.search_batch(q, K)
    port_ids, _ = port.search_batch(torch.from_numpy(q), K)
    gt = _oracle(dict(enumerate(x)), q, "cosine")
    assert _overlap(port_ids, ref_ids) >= 0.99
    assert _overlap(port_ids, gt) >= _overlap(ref_ids, gt) - 0.005


def test_scan_ivf_untrained_falls_back_like_reference():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(200, 16)).astype(np.float32)  # < 256 centroids
    q = rng.normal(size=(2, 16)).astype(np.float32)
    cfg = dict(search_mode="scan_ivf")
    ref = ref_hp.HnswPqIndex(16, 1000, "l2", RefConfig(**cfg))
    port = hp.HnswPqIndex(16, 1000, "l2", HnswPqConfig(**cfg), device="cpu")
    ref.bulk_load(list(range(200)), x)
    port.bulk_load(list(range(200)), x)
    assert not port.trained and port.coarse_centroids is None
    ref_ids, _ = ref.search_batch(q, 5)
    port_ids, _ = port.search_batch(torch.from_numpy(q), 5)
    np.testing.assert_array_equal(port_ids, ref_ids)


def test_scan_ivf_without_a_coarse_quantizer_raises():
    """Trained under another mode with nlist=0, then switched to scan_ivf:
    no coarse quantizer exists, as in the reference."""
    x, q, _ = _corpus(10, 3000, 16)
    port = hp.HnswPqIndex(16, 3000, "l2", HnswPqConfig(
        num_subspaces=4, training_samples=1000), device="cpu")
    port.bulk_load(list(range(3000)), x)
    port.config.search_mode = "scan_ivf"
    with pytest.raises(ValueError, match="coarse quantizer"):
        port.search_batch(torch.from_numpy(q), K)


def test_nlist_under_another_mode_assigns_like_reference():
    """nlist > 0 under scan_exact: the reference's coarse state loads, new
    rows are assigned to their nearest centroid in blocks, removed rows
    get -1, exactly as in the reference."""
    x, q, rng = _corpus(11, 4000, 16)
    cfg = dict(nlist=16, num_subspaces=4, training_samples=1000,
               search_mode="scan_exact")
    ref, port = _pair(x, cfg, 5000)
    assert (ref.coarse_assign[:4000] >= 0).all()
    np.testing.assert_array_equal(port.coarse_assign, ref.coarse_assign)
    new = rng.normal(size=(100, 16)).astype(np.float32) * 3.0
    assert port.add_batch(range(9000, 9100), new) == \
        ref.add_batch(range(9000, 9100), new)
    assert port.remove(5) and ref.remove(5)
    np.testing.assert_array_equal(port.coarse_assign, ref.coarse_assign)
    assert _overlap(port.search_batch(torch.from_numpy(q), K)[0],
                    ref.search_batch(q, K)[0]) >= 0.99


def test_the_port_trains_its_coarse_quantizer_when_streaming():
    """bulk_load_stream sizes nlist from the capacity, trains the coarse
    quantizer on the first chunk and assigns every chunk, as the
    reference does; the port's own index finds the true neighbours."""
    x, q, _ = _corpus(12, 6000, 32)
    cfg = HnswPqConfig(search_mode="scan_ivf", raw_store=False,
                       refine_residual=True, num_subspaces=8, nprobe=8,
                       training_samples=2000)
    port = hp.HnswPqIndex(32, 6000, "l2", cfg, device="cpu")
    port.bulk_load_stream([(range(s, s + 3000), x[s:s + 3000])
                           for s in (0, 3000)])
    cap = port.store.capacity
    assert port.config.nlist == ref_ivf.auto_ivf_geometry(cap, winners=4)[0]
    assert (port.coarse_assign[:6000] >= 0).all()
    ids, _ = port.search_batch(torch.from_numpy(q), K)
    assert _overlap(ids, _oracle(dict(enumerate(x)), q)) >= 0.95


# ---------------------------------------------------------------- k-means
def test_kmeans_fit_blocked_matches_dense():
    """Same generator, same random init: the blocked Lloyd is the dense one
    with its sums in another order."""
    rng = np.random.default_rng(11)
    x = _t(_mixture(rng, 2048, 24, modes=16)[0])
    dense, _ = tkm.kmeans_fit(torch.Generator().manual_seed(5), x[None], k=16,
                              iters=6, plus_plus=False)
    blocked = tkm.kmeans_fit_blocked(torch.Generator().manual_seed(5), x,
                                     k=16, iters=6, chunk=256)
    np.testing.assert_allclose(blocked.numpy(), dense[0].numpy(), rtol=2e-3,
                               atol=2e-3)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tkm.kmeans_fit_blocked(torch.Generator(), x[:1000], k=4, chunk=256)


def test_coarse_kmeans_routes_to_the_blocked_lloyd(monkeypatch):
    called = {}
    orig = hp.kmeans_fit_blocked

    def spy(*a, **kw):
        called["chunk"] = kw["chunk"]
        return orig(*a, **kw)

    monkeypatch.setattr(hp, "kmeans_fit_blocked", spy)
    ix = hp.HnswPqIndex(16, 4096, "l2", HnswPqConfig(
        search_mode="scan_ivf", num_subspaces=8, training_iterations=1),
        device="cpu")
    rng = np.random.default_rng(12)
    big = _t(np.tile(_mixture(rng, 3000, 16, modes=10)[0], (45, 1)))
    cents = ix._coarse_kmeans(big, 1024)  # 135k rows x 1024 > 2^27
    assert called["chunk"] == 65536 and tuple(cents.shape) == (1024, 16)
    called.clear()
    ix._coarse_kmeans(big[:3000], 64)     # small: the dense fit
    assert not called


# ------------------------------------------------------- fused_scan_topk (B1)
@pytest.fixture(scope="module")
def scan_data():
    r = np.random.default_rng(42)
    base = r.standard_normal((2048, 64)).astype(np.float32)
    q = r.standard_normal((16, 64)).astype(np.float32)
    return q, base


@pytest.mark.parametrize("k,winners,mask,block_n", [
    (5, 1, False, 256),
    (5, 2, False, 256),
    (5, 1, True, 256),    # the first block's rows masked by a +inf norm
    (20, 1, False, 256),  # k past the 16 buckets: (+inf, -1) pads
    (40, 2, True, 512),   # k past 2 x 16 winners
])
def test_scan_topk_plain_matches_reference(scan_data, k, winners, mask,
                                           block_n):
    q, base = scan_data
    bn = (base * base).sum(1)
    if mask:
        bn[:64] = np.inf
    jd, ji = ref_pk.fused_scan_topk(jnp.asarray(q), jnp.asarray(base),
                                    jnp.asarray(bn), k, q_tile=8,
                                    block_n=block_n, winners=winners,
                                    interpret=True)
    td, ti = tk.fused_scan_topk(_t(q), _t(base), _t(bn), k, q_tile=8,
                                block_n=block_n, winners=winners)
    assert tuple(ti.shape) == (16, k)
    res = tk.check_scan_topk((td, ti), (_t(jd), _t(ji)), _t(q), _t(base),
                             _t(bn))
    assert res["ok"], res
    if mask:
        assert not np.isin(ti.numpy(), np.arange(64)).any()


@pytest.mark.parametrize("qn,n,d,winners", [(5, 1000, 48, 1), (3, 777, 20, 2),
                                            (9, 2500, 33, 2)])
def test_scan_topk_plain_ragged_matches_reference(qn, n, d, winners):
    r = np.random.default_rng(qn * n)
    base = r.standard_normal((n, d)).astype(np.float32)
    q = r.standard_normal((qn, d)).astype(np.float32)
    bn = (base * base).sum(1)
    bn[r.uniform(size=n) < 0.05] = np.inf
    jd, ji = ref_pk.fused_scan_topk(jnp.asarray(q), jnp.asarray(base),
                                    jnp.asarray(bn), 7, q_tile=8, block_n=256,
                                    winners=winners, interpret=True)
    td, ti = tk.fused_scan_topk(_t(q), _t(base), _t(bn), 7, q_tile=8,
                                block_n=256, winners=winners)
    res = tk.check_scan_topk((td, ti), (_t(jd), _t(ji)), _t(q), _t(base),
                             _t(bn))
    assert res["ok"], res
    assert (ti.numpy() < n).all()


def test_scan_topk_plain_winner_columns_follow_the_reference_grid():
    """Ties between buckets resolve as in the reference: the winners sit in
    its grid's column order, so equal distances return the same ids."""
    base = np.zeros((1024, 8), np.float32)
    base[::7] = 1.0                      # many exact ties
    q = np.zeros((2, 8), np.float32)
    bn = (base * base).sum(1)
    for winners in (1, 2):
        jd, ji = ref_pk.fused_scan_topk(jnp.asarray(q), jnp.asarray(base),
                                        jnp.asarray(bn), 6, q_tile=8,
                                        block_n=256, winners=winners,
                                        interpret=True)
        td, ti = tk.fused_scan_topk(_t(q), _t(base), _t(bn), 6, q_tile=8,
                                    block_n=256, winners=winners)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
