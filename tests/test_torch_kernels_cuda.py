"""The port's CUDA kernels against their plain PyTorch versions on the card
(``ops/kernels.py``): B2 ``fused_int8_pool``, B3 ``pq_decode_recon_t``, B4
``fused_packed_pool`` and B7 ``fused_int8g_pool`` bit-equal; B6
``fused_raw_pool`` and B5 ``fused_adc_pool`` (the wgmma tile loop, at the
main path's shapes and the ragged ones) within the f32 summation-order
bound of ``ops/kernels.check_float_pool``; B8 ``fused_ivf_pool`` bit-equal on
the rows the merge reads (and writing no other row), B1
``fused_scan_topk`` within the bound of ``ops/kernels.check_scan_topk``;
all six pools at rows of any width (516, 768, 1024, 1536 dims); and the
plain-PyTorch paths on the card against the CPU: the graph build and search
(``ops/hnsw_graph``), the chunked proxy scan (``ops/pca``), and
``ops/adc.adc_decode_topk`` launching B3; the padded-8 search replayed from
a CUDA graph (``index/q8graph.py``) bit-equal to its eager path, under
writes and concurrent readers, its B2 launches seen by the profiler.  Every
test is marked ``cuda`` and skips without a card.  This file imports no JAX, so it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda
"""

import pytest

torch = pytest.importorskip("torch")

from vector_db_torch.index import hnsw_pq as hp  # noqa: E402
from vector_db_torch.ops import kernels as tk  # noqa: E402


@pytest.mark.cuda
def test_kernel_bit_equal_to_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    for qn, n, d, w in [(13, 4000, 512, 64), (70, 5000, 36, 300),
                        (1, 9000, 64, 2048)]:
        q = torch.randn(qn, d, device="cuda", generator=g)
        b8 = torch.randint(-127, 128, (n, d), device="cuda", generator=g,
                           dtype=torch.int8)
        off = torch.rand(n, device="cuda", generator=g)
        off[::7] = float("inf")
        sc = -torch.rand(n, device="cuda", generator=g)
        before = tk.fused_int8_pool.launches
        v1, s1 = tk.fused_int8_pool(q, b8, off, sc, w)
        v2, s2 = tk.fused_int8_pool_plain(q, b8, off, sc, w)
        torch.cuda.synchronize()
        assert tk.fused_int8_pool.launches == before + 1
        assert torch.equal(v1, v2) and torch.equal(s1, s2)


@pytest.mark.cuda
def test_decode_and_packed_kernels_bit_equal_to_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(1)
    for s, sd, k, n in [(64, 8, 256, 4000), (16, 4, 200, 5003)]:
        codes = torch.randint(0, k, (s, n + 64), device="cuda", generator=g,
                              dtype=torch.uint8)[:, 32:32 + n]
        cbt = torch.randn(s * sd, k, device="cuda", generator=g)
        before = tk.pq_decode_recon_t.launches
        got = tk.pq_decode_recon_t(codes, cbt)
        assert torch.equal(got, tk.pq_decode_recon_t_plain(codes, cbt))
        assert tk.pq_decode_recon_t.launches == before + 1
    for qn, n, d, w in [(13, 4096, 512, 512), (1, 8192, 64, 2048)]:
        b8 = torch.randint(-127, 128, (n, d), device="cuda", generator=g,
                           dtype=torch.int8)
        packed = b8.view(torch.int32)
        q = torch.randn(qn, d, device="cuda", generator=g)
        off = torch.rand(n, device="cuda", generator=g)
        off[::9] = float("inf")
        sc = -torch.rand(n, device="cuda", generator=g)
        before = tk.fused_packed_pool.launches
        v1, s1 = tk.fused_packed_pool(q, packed, off, sc, w)
        v2, s2 = tk.fused_packed_pool_plain(q, packed, off, sc, w)
        torch.cuda.synchronize()
        assert tk.fused_packed_pool.launches == before + 1
        assert torch.equal(v1, v2) and torch.equal(s1, s2)


@pytest.mark.cuda
def test_new_pool_kernels_agree_with_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(2)
    dev = "cuda"
    for qn, n, d, w in [(13, 4000, 512, 64), (70, 5000, 64, 300),
                        (1, 9000, 32, 2048)]:
        base = torch.randn(n, d, device=dev, generator=g) + 1.0
        valid = torch.rand(n, device=dev, generator=g) > 0.1
        norms = (base * base).sum(1)
        q = torch.randn(qn, d, device=dev, generator=g) + 1.0
        # B7: bit-equal
        b8, off, sv, sgn, cvec, _ = hp._build_scan8g_shadow(
            base, norms, valid, "l2", 1)
        before = tk.fused_int8g_pool.launches
        got = tk.fused_int8g_pool(q - cvec, b8, off, sv, sgn, w)
        want = tk.fused_int8g_pool_plain(q - cvec, b8, off, sv, sgn, w)
        torch.cuda.synchronize()
        assert tk.fused_int8g_pool.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        # B6: within the summation-order bound
        b16, off, sc, cvec, _ = hp._build_scan16_shadow(
            base, norms, valid, "l2", 1)
        qc = q - cvec
        got = tk.fused_raw_pool(qc, b16, off, sc, w)
        want = tk.fused_raw_pool_plain(qc, b16, off, sc, w)
        res = tk.check_float_pool(
            got, want, lambda s: tk.raw_pool_terms(qc, b16, off, sc, s),
            tk.pool_width(w))
        assert res["ok"], res
    for s, sd, k, n in [(64, 8, 256, 4000), (16, 4, 200, 5003)]:
        codes = torch.randint(0, k, (s, n + 64), device=dev, generator=g,
                              dtype=torch.uint8)[:, 32:32 + n]
        cbt = torch.randn(s * sd, k, device=dev, generator=g)
        mn = torch.rand(n, device=dev, generator=g) * 50
        mn[::11] = float("inf")
        q = torch.randn(9, s * sd, device=dev, generator=g)
        before = tk.fused_adc_pool.launches
        got = tk.fused_adc_pool(q, codes, cbt, mn, 512)
        want = tk.fused_adc_pool_plain(q, codes, cbt, mn, 512)
        assert tk.fused_adc_pool.launches == before + 1
        res = tk.check_float_pool(
            got, want, lambda sl: tk.adc_pool_terms(q, codes, cbt, mn, sl),
            512)
        assert res["ok"], res


@pytest.mark.cuda
def test_ivf_pool_bit_equal_to_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(4)
    dev = "cuda"
    for nlist, cap, p_cap, d, winners in [(7, 512, 96, 64, 4), (5, 1024, 32,
                                                                  36, 1),
                                          (9, 256, 64, 512, 2)]:
        qsel = torch.randint(-127, 128, (nlist * p_cap, d), device=dev,
                             generator=g, dtype=torch.int8).view(torch.int32)
        cm = torch.randint(-127, 128, (nlist * cap, d), device=dev,
                           generator=g, dtype=torch.int8).view(torch.int32)
        off = torch.randn(nlist * cap, device=dev, generator=g) * 100
        off[torch.rand(nlist * cap, device=dev, generator=g) < 0.1] = \
            float("inf")
        sc = -torch.rand(nlist * cap, device=dev, generator=g) * 0.05
        counts = torch.randint(0, p_cap + 1, (nlist,), device=dev,
                               generator=g, dtype=torch.int32)
        counts[0] = 0
        before = tk.fused_ivf_pool.launches
        kv, kp = tk.fused_ivf_pool(counts, qsel, cm, off, sc, nlist, cap,
                                   p_cap, winners)
        pv, pp = tk.fused_ivf_pool_plain(counts, qsel, cm, off, sc, nlist,
                                         cap, p_cap, winners)
        torch.cuda.synchronize()
        assert tk.fused_ivf_pool.launches == before + 1
        rows = torch.cat([c * p_cap + torch.arange(int(counts[c]),
                                                   device=dev)
                          for c in range(nlist)])
        assert torch.equal(kv[rows], pv[rows])
        fin = torch.isfinite(pv[rows])
        assert torch.equal(kp[rows][fin], pp[rows][fin])


def _ivf_inputs(g, nlist, cap, p_cap, d):
    dev = "cuda"
    qsel = torch.randint(-127, 128, (nlist * p_cap, d), device=dev,
                         generator=g, dtype=torch.int8).view(torch.int32)
    cm = torch.randint(-127, 128, (nlist * cap, d), device=dev,
                       generator=g, dtype=torch.int8).view(torch.int32)
    off = torch.randn(nlist * cap, device=dev, generator=g) * 100
    off[torch.rand(nlist * cap, device=dev, generator=g) < 0.1] = float("inf")
    sc = -torch.rand(nlist * cap, device=dev, generator=g) * 0.05
    return qsel, cm, off, sc


def _hold_ivf_with_canary(counts, qsel, cm, off, sc, nlist, cap, p_cap,
                          winners):
    """B8 bit-equal to its plain version on the rows a merge reads, with
    and without the caller's probe count; every other row keeps the
    sentinel the outputs were filled with."""
    pv, pp = tk.fused_ivf_pool_plain(counts, qsel, cm, off, sc, nlist, cap,
                                     p_cap, winners)
    rows = torch.cat([c * p_cap + torch.arange(int(counts[c]), device="cuda")
                      for c in range(nlist)])
    other = torch.ones(nlist * p_cap, dtype=torch.bool, device="cuda")
    other[rows] = False
    fin = torch.isfinite(pv[rows])
    for probes in (None, int(counts.sum())):
        out = (torch.full_like(pv, -12345.0), torch.full_like(pp, -777))
        before = tk.fused_ivf_pool.launches
        kv, kp = tk.fused_ivf_pool(counts, qsel, cm, off, sc, nlist, cap,
                                   p_cap, winners, probes=probes, out=out)
        torch.cuda.synchronize()
        assert tk.fused_ivf_pool.launches == before + 1
        assert kv is out[0] and kp is out[1]
        assert torch.equal(kv[rows], pv[rows])
        assert torch.equal(kp[rows][fin], pp[rows][fin])
        assert (kv[other] == -12345.0).all() and (kp[other] == -777).all()


@pytest.mark.cuda
@pytest.mark.parametrize("nlist,cap,p_cap,winners", [
    (37, 2688, 32, 4),    # a 128-row box runs over four clusters' probers
    (37, 2688, 64, 4),
    (9, 1024, 160, 2),    # a second tile of 32 rows
    (64, 128, 64, 4),     # one bucket a cluster
    (5, 4096, 40, 4),     # the pool row full
    (3, 128, 8, 40),      # more winners than a quad has lanes
])
def test_ivf_pool_writes_only_the_rows_it_owns_on_card(nlist, cap, p_cap,
                                                       winners):
    """Prober counts that end mid-tile: no row at or past a cluster's count
    is written, above all none past p_cap (the next cluster's rows), and no
    row of an unprobed cluster."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(11 + cap + p_cap)
    counts = torch.randint(0, p_cap + 1, (nlist,), device="cuda",
                           generator=g, dtype=torch.int32)
    counts[::4] = 0
    counts[1] = p_cap
    counts[2] = 1
    _hold_ivf_with_canary(counts, *_ivf_inputs(g, nlist, cap, p_cap, 512),
                          nlist, cap, p_cap, winners)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [36, 516, 768, 1024, 1536])
def test_ivf_pool_takes_rows_of_any_width_on_card(d):
    """B8 at rows that are not whole 16-byte vectors (36, 516: the cp.async
    producer and a padded prober tile) and past the resident prober tile
    (1536: the streamed layout), two prober tiles a cluster."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(13 + d)
    nlist, cap, p_cap = 11, 640, 200
    counts = torch.randint(0, p_cap + 1, (nlist,), device="cuda",
                           generator=g, dtype=torch.int32)
    counts[0] = 0
    counts[1] = p_cap
    _hold_ivf_with_canary(counts, *_ivf_inputs(g, nlist, cap, p_cap, d),
                          nlist, cap, p_cap, 4)


@pytest.mark.cuda
def test_scan_topk_within_bound_of_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(5)
    for qn, n, d, k, winners in [(13, 4000, 512, 10, 1), (70, 5003, 36, 20, 2),
                                 (1, 300, 64, 10, 2)]:
        base = torch.randn(n, d, device="cuda", generator=g)
        q = torch.randn(qn, d, device="cuda", generator=g)
        bn = (base * base).sum(1)
        bn[::17] = float("inf")
        before = tk.fused_scan_topk.launches
        got = tk.fused_scan_topk(q, base, bn, k, winners=winners)
        want = tk.fused_scan_topk_plain(q, base, bn, k, winners=winners)
        torch.cuda.synchronize()
        assert tk.fused_scan_topk.launches == before + 1
        res = tk.check_scan_topk(got, want, q, base, bn)
        assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 96, 512, 592, 640])
def test_raw_pool_ragged_shapes_within_bound_on_card(d):
    """B6 on the wgmma tile loop: queries past one 128-row tile, d not a
    multiple of the 64-dim k-chunk (592, and 640, the widest resident query
    tile: a three-stage ring), N not a multiple of the pool width, and a
    width the shadow did not pad."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(6)
    n = 5003
    base = torch.randn(n, d, device="cuda", generator=g) + 0.5
    valid = torch.rand(n, device="cuda", generator=g) > 0.05
    b16, off, sc, cvec, _ = hp._build_scan16_shadow(
        base, (base * base).sum(1), valid, "l2", 1)
    for qn in (1, 13, 129, 1024):
        q = torch.randn(qn, d, device="cuda", generator=g) - cvec
        before = tk.fused_raw_pool.launches
        got = tk.fused_raw_pool(q, b16, off, sc, 300)
        want = tk.fused_raw_pool_plain(q, b16, off, sc, 300)
        torch.cuda.synchronize()
        assert tk.fused_raw_pool.launches == before + 1
        res = tk.check_float_pool(
            got, want, lambda s, q=q: tk.raw_pool_terms(q, b16, off, sc, s),
            tk.pool_width(300))
        assert res["ok"], (qn, res)
    if d != 96:
        return
    # rows of 36 dims: not whole 16-byte vectors, so the wrapper pads a copy
    b36 = b16[:, :36].contiguous()
    q = torch.randn(13, 36, device="cuda", generator=g)
    got = tk.fused_raw_pool(q, b36, off, sc, 300)
    want = tk.fused_raw_pool_plain(q, b36, off, sc, 300)
    res = tk.check_float_pool(
        got, want, lambda s: tk.raw_pool_terms(q, b36, off, sc, s),
        tk.pool_width(300))
    assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("s,sd", [(16, 2), (96, 1), (128, 4), (74, 8),
                                  (37, 16)])
def test_adc_pool_ragged_shapes_within_bound_on_card(s, sd):
    """B5 on the wgmma tile loop: codebook entries of 4, 2, 8, 16 and 32
    bytes (the decode's unit templates), d in {32, 96, 512, 592}, K=200,
    N not a multiple of the pool width, code slices that start at an odd
    column (byte code loads) and at an aligned one, Q past one tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(7)
    k, n, w = 200, 5003, 300
    cbt = torch.randn(s * sd, k, device="cuda", generator=g) * 0.3
    wide = torch.randint(0, k, (s, n + 128), device="cuda", generator=g,
                         dtype=torch.uint8)
    for start in (1, 64):
        codes = wide[:, start:start + n]
        mn = tk.pq_decode_recon_t_plain(codes, cbt).float().square().sum(0)
        mn[::13] = float("inf")
        for qn in (1, 13, 129, 1024):
            q = torch.randn(qn, s * sd, device="cuda", generator=g)
            before = tk.fused_adc_pool.launches
            got = tk.fused_adc_pool(q, codes, cbt, mn, w)
            want = tk.fused_adc_pool_plain(q, codes, cbt, mn, w)
            torch.cuda.synchronize()
            assert tk.fused_adc_pool.launches == before + 1
            res = tk.check_float_pool(
                got, want,
                lambda sl, q=q, codes=codes, mn=mn: tk.adc_pool_terms(
                    q, codes, cbt, mn, sl),
                tk.pool_width(w))
            assert res["ok"], (start, qn, res)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [516, 768, 1024, 1536])
def test_pools_take_rows_of_any_width_on_card(d):
    """All six pools at widths past the old limits: 516 (s8 rows that are
    not whole 16-byte vectors: the cp.async producer), 768 and 1024 (bf16
    rows past the resident query tile: the streamed layout), 1536 (past
    2^24 in the s8 cross term).  The s8 pools bit-equal, the bf16 pools
    within the summation-order bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(8 + d)
    dev, qn, n, w = "cuda", 129, 4096, 512
    q = torch.randn(qn, d, device=dev, generator=g)
    b8 = torch.randint(-127, 128, (n, d), device=dev, generator=g,
                       dtype=torch.int8)
    off = torch.rand(n, device=dev, generator=g)
    off[::7] = float("inf")
    sc = -torch.rand(n, device=dev, generator=g)
    for kernel, plain, rows in (
            (tk.fused_int8_pool, tk.fused_int8_pool_plain, b8),
            (tk.fused_packed_pool, tk.fused_packed_pool_plain,
             b8.view(torch.int32))):
        got, want = kernel(q, rows, off, sc, w), plain(q, rows, off, sc, w)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    base = torch.randn(n, d, device=dev, generator=g) + 1.0
    valid = torch.rand(n, device=dev, generator=g) > 0.1
    norms = (base * base).sum(1)
    g8, goff, sv, sgn, cvec, _ = hp._build_scan8g_shadow(base, norms, valid,
                                                         "l2", 1)
    got = tk.fused_int8g_pool(q - cvec, g8, goff, sv, sgn, w)
    want = tk.fused_int8g_pool_plain(q - cvec, g8, goff, sv, sgn, w)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    b16, roff, rsc, cvec, _ = hp._build_scan16_shadow(base, norms, valid,
                                                      "l2", 1)
    qc = q - cvec
    res = tk.check_float_pool(
        tk.fused_raw_pool(qc, b16, roff, rsc, w),
        tk.fused_raw_pool_plain(qc, b16, roff, rsc, w),
        lambda s: tk.raw_pool_terms(qc, b16, roff, rsc, s), w)
    assert res["ok"], res
    s, sd = d // 4, 4
    codes = torch.randint(0, 256, (s, n), device=dev, generator=g,
                          dtype=torch.uint8)
    cbt = torch.randn(s * sd, 256, device=dev, generator=g) * 0.3
    mn = tk.pq_decode_recon_t_plain(codes, cbt).float().square().sum(0)
    res = tk.check_float_pool(
        tk.fused_adc_pool(q, codes, cbt, mn, w),
        tk.fused_adc_pool_plain(q, codes, cbt, mn, w),
        lambda sl: tk.adc_pool_terms(q, codes, cbt, mn, sl), w)
    assert res["ok"], res
    nlist, cap, p_cap = 5, 256, 64
    qsel = b8[:nlist * p_cap].view(torch.int32)
    cm = b8[:nlist * cap].view(torch.int32)
    counts = torch.tensor([64, 0, 3, 40, 17], device=dev, dtype=torch.int32)
    kv, kp = tk.fused_ivf_pool(counts, qsel, cm, off[:nlist * cap],
                               sc[:nlist * cap], nlist, cap, p_cap, 2)
    pv, pp = tk.fused_ivf_pool_plain(counts, qsel, cm, off[:nlist * cap],
                                     sc[:nlist * cap], nlist, cap, p_cap, 2)
    torch.cuda.synchronize()
    rows = torch.cat([c * p_cap + torch.arange(int(counts[c]), device=dev)
                      for c in range(nlist)])
    assert torch.equal(kv[rows], pv[rows])
    fin = torch.isfinite(pv[rows])
    assert torch.equal(kp[rows][fin], pp[rows][fin])


def _recall(got, want, k):
    return float((got[:, :, None] == want[:, None, :]).any(2).float().mean())


@pytest.mark.cuda
def test_graph_build_and_search_on_card_match_the_cpu():
    """The graph engine is plain PyTorch: from the same seeded rows and
    levels the card builds the CPU's graph (at least 99% of the adjacency
    rows equal as sets: the products sum in another order) and a search
    reaches the CPU's recall within 0.005; the delta insert likewise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from vector_db_torch.ops import hnsw_graph as hg
    from vector_db_torch.ops.distance import blocked_knn

    r = np.random.default_rng(3)
    n, extra, cap, d, m = 3000, 200, 4096, 64, 16
    base = torch.zeros(cap, d)
    base[:n + extra] = torch.from_numpy(
        r.standard_normal((n + extra, d)).astype(np.float32))
    queries = torch.from_numpy(r.standard_normal((64, d)).astype(np.float32))
    u = r.uniform(1e-12, 1.0, n + extra)
    levels = np.clip(np.floor(-np.log(u) / np.log(m)).astype(np.int32), 0, 2)
    slots = np.arange(n + extra, dtype=np.int32)
    valid = torch.zeros(cap, dtype=torch.bool)
    valid[:n + extra] = True
    graphs, answers = {}, {}
    for dev in ("cpu", "cuda"):
        b, v = base.to(dev), valid.to(dev)
        norms = torch.sum(b * b, dim=1)
        g = hg.bulk_build(hg.init_graph(cap, m, 3, dev), b, norms, slots[:n],
                          levels[:n], m=m)
        hg.bulk_insert_delta(g, b, norms, v, slots[n:], levels[n:], m=m)
        graphs[dev] = g
        answers[dev] = hg.hnsw_search(g, b, norms, v, queries.to(dev), 16,
                                      96)[1].cpu()
    a, c = graphs["cuda"], graphs["cpu"]
    assert (a.entry, a.entry_level) == (c.entry, c.entry_level)
    assert torch.equal(a.levels.cpu(), c.levels)
    rows_a = torch.sort(a.neighbors.cpu().reshape(-1, m), dim=1)[0]
    rows_c = torch.sort(c.neighbors.reshape(-1, m), dim=1)[0]
    assert float((rows_a == rows_c).all(1).float().mean()) >= 0.99
    gt = blocked_knn(queries, base, valid, 16)[1]
    assert _recall(answers["cuda"], gt, 16) \
        >= _recall(answers["cpu"], gt, 16) - 0.005
    assert _recall(answers["cuda"], gt, 16) >= 0.9


@pytest.mark.cuda
def test_pca_chunked_branch_on_card_matches_the_cpu():
    """The chunked proxy scan (a ragged last chunk) on the card: the bf16
    product accumulates in f32 there as on the CPU, so the answers agree
    (at least 99% of the ids) and equal the full-row branch's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from vector_db_torch.ops import pca

    r = np.random.default_rng(4)
    n, d, p = 5000, 64, 16
    base = (r.standard_normal((n, d)) * (np.arange(d) + 1.0) ** -0.8
            ).astype(np.float32)
    queries = torch.from_numpy(
        (r.standard_normal((32, d)) * (np.arange(d) + 1.0) ** -0.8
         ).astype(np.float32))
    mu, basis = pca.pca_fit(base[:2000], p)
    out = {}
    for dev in ("cpu", "cuda"):
        b = torch.from_numpy(base).to(dev)
        mean, bas = torch.from_numpy(mu).to(dev), torch.from_numpy(basis).to(dev)
        proxy = pca.project_rows(b, mean, bas)
        args = (queries.to(dev), mean, bas, proxy, pca.rows_sq_norms(proxy),
                torch.ones(n, dtype=torch.bool, device=dev), b,
                torch.arange(n, dtype=torch.int32, device=dev))
        out[dev] = pca.pca_proxy_search(*args, k=16, select_r=128,
                                        block_n=1536, force_chunked=True)
        full = pca.pca_proxy_search(*args, k=16, select_r=128)
        assert torch.equal(out[dev][1], full[1])
    same = out["cuda"][1].cpu() == out["cpu"][1]
    assert float(same.float().mean()) >= 0.99
    assert torch.allclose(out["cuda"][0].cpu()[same], out["cpu"][0][same],
                          rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_adc_decode_topk_launches_the_decode_kernel():
    """adc_decode_topk on CUDA tensors runs B3 (one launch for the cross
    terms, one for the norms when none are cached) and ranks the ADC
    distances of adc_scan_topk up to the bf16 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from vector_db_torch.ops import adc

    g = torch.Generator(device="cuda").manual_seed(5)
    s, sd, k, n, qn = 16, 4, 256, 6000, 24
    codebooks = torch.randn(s, k, sd, device="cuda", generator=g)
    codes = torch.randint(0, k, (n, s), device="cuda", generator=g,
                          dtype=torch.uint8)
    queries = torch.randn(qn, s * sd, device="cuda", generator=g)
    valid = torch.rand(n, device="cuda", generator=g) > 0.1
    before = tk.pq_decode_recon_t.launches
    dec_d, dec_i = adc.adc_decode_topk(
        queries, codes.T.contiguous(), adc.codebooks_to_cbt(codebooks), valid,
        32)
    assert tk.pq_decode_recon_t.launches == before + 2
    tables = adc.build_distance_tables(queries, codebooks)
    scan_d, scan_i = adc.adc_scan_topk(tables, codes, valid, 32)
    assert torch.allclose(dec_d, scan_d, rtol=2e-2, atol=1e-2)
    assert _recall(dec_i, scan_i, 32) >= 0.9
    assert bool(valid[dec_i.long()].all())
    onehot_d, _ = adc.adc_scan_topk(tables, codes, valid, 32, impl="onehot")
    assert torch.allclose(onehot_d, scan_d, rtol=2e-2, atol=1e-2)


@pytest.mark.cuda
def test_pq_index_on_card_matches_the_cpu():
    """A flat PqIndex on the card, loaded with a CPU index's codebooks,
    codes and rows, searches through the decode kernel (B3) and returns
    the CPU index's ids (>= 99% shared: the card's product takes bf16
    queries, the CPU's f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import numpy as np

    from vector_db_torch.api.config import PqConfig
    from vector_db_torch.index.pq import PqIndex

    r = np.random.default_rng(6)
    rows = (r.standard_normal((3000, 64)) * (np.arange(64) + 1.0) ** -0.5
            ).astype(np.float32)
    queries = rows[:40] + 0.05 * r.standard_normal((40, 64)).astype(np.float32)
    for refine_k in (0, 128):
        cfg = PqConfig(num_subspaces=16, training_iterations=5,
                       refine_k=refine_k)
        cpu = PqIndex(64, 4096, "l2", cfg, device="cpu")
        cpu.add_batch(range(3000), rows)
        cpu.build()
        card = PqIndex(64, 4096, "l2", cfg, device="cuda")
        card.load_state_arrays(cpu.state_arrays())
        before = tk.pq_decode_recon_t.launches
        got, _ = card.search_batch(queries, 10)
        assert tk.pq_decode_recon_t.launches > before
        want, _ = cpu.search_batch(queries, 10)
        shared = np.mean([len(set(a) & set(b)) / 10
                          for a, b in zip(got, want)])
        assert shared >= 0.99, (refine_k, shared)



def _sharded_pool_case(name, dev, q, base, norms, valid, packed, scales,
                       resid, rscales, k=10, pool=64, w=2048):
    """One fused program of the sharded tier on four logical shards of
    ``dev`` and on four CPU shards, with the CPU's conditioning: each
    shard's pool on ``dev`` bit-equal to its plain version there, then the
    merged results against the CPU shards'."""
    from vector_db_torch.parallel import sharded as sh

    cpu = torch.device("cpu")
    meshes = sh.make_mesh(devices=[cpu] * 4), sh.make_mesh(devices=[dev] * 4)
    if name == "int8":
        cond_t = sh.sharded_cond_int8(meshes[0])(
            *sh.shard_corpus(meshes[0], packed, scales, norms, valid))
        kernel = tk.fused_packed_pool
        stores = [sh.shard_corpus(m, packed, scales, norms, resid, rscales)
                  for m in meshes]
    else:
        cond_t = getattr(sh, f"sharded_cond_{name}")(meshes[0])(
            *sh.shard_corpus(meshes[0], base, norms, valid))
        kernel = tk.fused_int8_pool if name == "raw8" else tk.fused_int8g_pool
        stores = [sh.shard_corpus(m, base) for m in meshes]
    conds = cond_t, [[t.to(dev) for t in col] for col in cond_t]
    plain = getattr(tk, kernel.__name__ + "_plain")
    cond, store = conds[1], stores[1]
    for i in range(4):  # each shard's pool against its plain version
        if name == "int8":
            args = (store[0][i], cond[0][i], cond[1][i])
        elif name == "raw8":
            args = (cond[0][i], cond[1][i], cond[2][i])
        else:
            args = (cond[0][i], cond[1][i], cond[2][i][0], 2.0)
        qc = (q - cond_t[-1][i][0]).to(dev)
        got, want = kernel(qc, *args, w), plain(qc, *args, w)
        assert torch.equal(got[0], want[0]), (name, i)
        assert torch.equal(got[1], want[1]), (name, i)
    out = []
    for mesh, cond, store in zip(meshes, conds, stores):
        qd = q.to(mesh.devices[0])
        if name == "int8":
            out.append(sh.sharded_fused_int8(mesh, k, pool, w, residual=True)(
                qd, *store[:3], *cond, *store[3:]))
        else:
            prog = getattr(sh, f"sharded_fused_{name}")
            out.append(prog(mesh, k, pool, w)(qd, store[0], *cond))
    (want_d, want_i), (got_d, got_i) = out
    same = got_i.cpu() == want_i
    # the card's query scales may sit a ulp from the CPU's, which can move
    # a candidate at the pool's edge
    assert same.float().mean() >= 0.99, (name, same.float().mean())
    # atol: f32 cancellation in |q|^2 + |v|^2 - 2 q.v at norms of ~256
    torch.testing.assert_close(got_d.cpu()[same], want_d[same], rtol=1e-5,
                               atol=1e-3)


@pytest.mark.cuda
def test_sharded_fused_programs_on_card_match_cpu_shards():
    """The sharded tier's three fused programs (``parallel/sharded.py``) on
    four logical shards of the card against four CPU shards: each shard's
    pool (B2, B7, B4) bit-equal to its plain version on the card, as the
    single-chip pools are held (the query's int8 scale is computed on the
    card, which divides by 127 as a product with its reciprocal), the
    merged ids equal at >= 99% of positions and their refined distances
    within f32 order; and the
    row packing on the card bit-equal to the CPU's (which the CPU tests
    hold to the reference's host numpy)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from vector_db_torch.ops.distance import pack_int8_rows
    from vector_db_torch.parallel import sharded as sh

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(3)
    n, d = 4 * 8192, 128
    base = torch.randn(n, d, generator=g) + 1.0
    valid = torch.rand(n, generator=g) > 0.05
    norms = (base * base).sum(1)
    q = base[:64] + 0.05 * torch.randn(64, d, generator=g)
    packed, scales = pack_int8_rows(base)
    resid, rscales = sh.pack_resid(base, packed, scales)
    on_card = pack_int8_rows(base.to(dev))
    assert torch.equal(on_card[0].cpu(), packed)
    assert torch.equal(on_card[1].cpu(), scales)
    assert torch.equal(sh.pack_resid(base.to(dev), *on_card)[0].cpu(), resid)
    for name, kernel in (("raw8", tk.fused_int8_pool),
                         ("raw8g", tk.fused_int8g_pool),
                         ("int8", tk.fused_packed_pool)):
        before = kernel.launches
        _sharded_pool_case(name, dev, q, base, norms, valid, packed, scales,
                           resid, rscales)
        assert kernel.launches == before + 8, name  # 4 held + 4 in the run


@pytest.mark.cuda
def test_spanning_mesh_of_one_rank_matches_the_single_controller(tmp_path):
    """Four shards of the card over a mesh that spans an NCCL group of one
    rank (the one-card case of a multi-card deployment: the merge's
    winners go through ``all_gather_into_tensor``) against the
    single-controller mesh of the same four shards: the exact and the
    fused program (B2, launched once a shard) give identical ids and
    distances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL and the kernels)")
    import torch.distributed as dist

    from vector_db_torch.parallel import sharded as sh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        meshes = (sh.make_mesh(devices=[dev] * 4, group=dist.group.WORLD),
                  sh.make_mesh(devices=[dev] * 4))
        assert meshes[0].global_shards == meshes[1].global_shards == 4
        g = torch.Generator(device="cuda").manual_seed(5)
        n_s, d = 8192, 128
        base = torch.randn(4 * n_s, d, device=dev, generator=g)
        valid = torch.rand(4 * n_s, device=dev, generator=g) > 0.05
        norms = (base * base).sum(1)
        q = base[:64] + 0.05 * torch.randn(64, d, device=dev, generator=g)
        w = tk.preserved_pool_width(n_s)
        outs = []
        for mesh in meshes:
            b, v, nr = sh.shard_corpus(mesh, base, valid, norms)
            exact = sh.sharded_knn(mesh, 10)(q, b, v, nr)
            cond = sh.sharded_cond_raw8(mesh)(b, nr, v)
            before = tk.fused_int8_pool.launches
            fused = sh.sharded_fused_raw8(mesh, 10, 64, w)(q, b, *cond)
            torch.cuda.synchronize()
            assert tk.fused_int8_pool.launches == before + 4
            outs.append(exact + fused)
        for got, want in zip(*outs):
            assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_search_on_a_side_stream_waits_for_the_shadow_it_reads():
    """Two readers of one database: A, on the default stream behind tens of
    ms of queued work, rebuilds the int8 shadow (the rows it covers were
    just added); B, in another thread whose current stream is one of its
    own, searches as soon as A has released the cache.  The facade runs
    both on the default stream (``core/device.on_default_stream``), so B's
    pool reads the shadow A built, and every new row is first for its own
    vector in both answers.  (Ordered by nothing, B's pool read the shadow
    before the default stream had written it.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (streams and the kernels)")
    import threading

    from vector_db_torch import HnswPqConfig, IndexType, VectorDatabase

    g = torch.Generator(device="cuda").manual_seed(7)
    n, extra, d = 20_000, 9_000, 128
    rows = torch.randn(n + extra, d, device="cuda", generator=g)
    db = (VectorDatabase.builder().with_dimension(d)
          .with_max_elements(n + extra).with_index_type(IndexType.HNSWPQ)
          .with_index_config(HnswPqConfig(num_subspaces=16,
                                          search_mode="scan_pallas_int8"))
          .with_device("cuda").build())
    db.add_batch(range(n), rows[:n])
    db.search_batch(rows[:8], 5)
    # past max(8192, capacity / 8) rows: the next search rebuilds whole
    db.add_batch(range(n, n + extra), rows[n:])
    torch.cuda.synchronize()
    a = torch.randn(4096, 4096, device="cuda", generator=g)
    out = torch.empty_like(a)
    side = torch.cuda.Stream()
    idx = db.index
    build = idx._scan8_shadow
    built, b_done = threading.Event(), threading.Event()
    answers = {}

    def shadow():
        value = build()
        if threading.current_thread().name == "A":
            built.set()
            b_done.wait(60)
        return value

    idx._scan8_shadow = shadow
    queries = rows[n:n + 256]

    def reader_a():
        torch.cuda.set_device(a.device)
        for _ in range(16):  # tens of ms queued on the default stream
            torch.mm(a, a, out=out)
        answers["A"] = db.search_batch(queries, 1)

    def reader_b():
        built.wait(60)
        try:
            with torch.cuda.stream(side):
                answers["B"] = db.search_batch(queries, 1)
        finally:
            b_done.set()

    threads = [threading.Thread(target=reader_a, name="A"),
               threading.Thread(target=reader_b, name="B")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    want = list(range(n, n + 256))
    for name in ("A", "B"):
        got = [row[0].id if row else -1 for row in answers[name]]
        assert got == want, (name, sum(x == y for x, y in zip(got, want)))
    db.close()


# ------------------------------------------- the padded-8 graph (q8graph)
def _q8_index(mode, metric, n=20_000, d=128, seed=0):
    """A trained raw-store HNSWPQ index on the card under ``mode``, its
    rows, and spare rows for writes."""
    from vector_db_torch.api.config import HnswPqConfig

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = torch.randn(n + 64, d, device="cuda", generator=g)
    idx = hp.HnswPqIndex(d, n + 2048, metric, HnswPqConfig(
        num_subspaces=16, search_mode=mode), device="cuda")
    idx.bulk_load(range(n), rows[:n])
    return idx, rows


def _q8_eager(idx, q, k):
    """The index's eager answer (its graphs set aside)."""
    from vector_db_torch.index import q8graph

    saved, idx._q8 = idx._q8, q8graph.Q8Graphs(idx.device)
    try:
        return idx.search_batch(q, k)
    finally:
        idx._q8 = saved


def _q8_counts():
    from vector_db_torch.utils.stats import GLOBAL

    got = GLOBAL.snapshot()["counts"]
    return {n: got.get(f"q8graph.{n}", 0)
            for n in ("captures", "replays", "eager")}


def _q8_same(got, want):
    import numpy as np

    return (np.array_equal(got[0], want[0])
            and np.array_equal(got[1].view(np.int32), want[1].view(np.int32)))


def _q8_hold(idx, q, k, label):
    """Three calls under one key (eager, capture and replay, replay), each
    bit-equal to the eager path; returns how many of them replayed."""
    want = _q8_eager(idx, q, k)
    before = _q8_counts()["replays"]
    for i in range(3):
        got = idx.search_batch(q, k)
        assert _q8_same(got, want), (label, i)
    return _q8_counts()["replays"] - before


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("mode", ["scan_exact", "scan_pallas_int8"])
def test_q8_graph_replays_bit_equal_to_eager_through_writes(mode, metric):
    """The captured modes replayed at Q = 1, 3 and 8 (host and device
    queries) give the eager path's ids and distances bit for bit, and again
    after an add, a delete, an update (in place: the same key) and the
    store's reallocations (a reload and a whole shadow rebuild: new keys,
    captured anew)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs)")
    idx, rows = _q8_index(mode, metric)
    n = 20_000
    for q_n in (1, 3, 8):
        q = (rows[:q_n] + 0.01).cpu().numpy()
        assert _q8_hold(idx, q, 10, f"Q={q_n}") >= 2
    assert _q8_hold(idx, rows[5:8] + 0.01, 10, "device queries") >= 2
    q = (rows[:3] + 0.01).cpu().numpy()
    captures = _q8_counts()["captures"]
    idx.add_batch([n], rows[n:n + 1])                          # add
    assert _q8_hold(idx, q, 10, "add") == 3
    top = int(idx.search_batch(q, 10)[0][0, 0])
    assert idx.remove(top)                                     # delete
    got = idx.search_batch(q, 10)
    assert top not in got[0][0]
    assert _q8_hold(idx, q, 10, "delete") == 3
    assert idx.remove(n)                                       # update
    idx.add_batch([n], (rows[1] + 0.001)[None])
    assert int(idx.search_batch(q, 10)[0][1, 0]) == n
    assert _q8_hold(idx, q, 10, "update") == 3
    assert _q8_counts()["captures"] == captures  # writes in place: one key
    idx.load_state_arrays(idx.state_arrays())                  # reload
    assert len(idx._q8._graphs) == 0
    assert _q8_hold(idx, q, 10, "reload") == 2
    idx._note_store_rewrite()                                  # rebuild
    idx.add_batch([n + 1], rows[n + 1:n + 2])
    assert _q8_hold(idx, q, 10, "shadow rebuild") >= 2
    # the reload's key, and the rebuilt shadow's (scan_exact reads none)
    assert _q8_counts()["captures"] == captures + (
        2 if mode == "scan_pallas_int8" else 1)


@pytest.mark.cuda
def test_q8_graph_concurrent_readers_get_their_eager_answers():
    """Four threads of ``db.search`` at once on one database, two keys
    (k = 10 and k = 5) shared between them: every answer equals its eager
    answer, and the calls were replayed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs)")
    import sys
    import threading

    from vector_db_torch import HnswPqConfig, IndexType, VectorDatabase
    from vector_db_torch.index import q8graph

    g = torch.Generator(device="cuda").manual_seed(3)
    n, d = 20_000, 128
    rows = torch.randn(n, d, device="cuda", generator=g)
    db = (VectorDatabase.builder().with_dimension(d).with_max_elements(n)
          .with_index_type(IndexType.HNSWPQ)
          .with_index_config(HnswPqConfig(num_subspaces=16,
                                          search_mode="scan_pallas_int8"))
          .with_device("cuda").build())
    db.bulk_load(range(n), rows)
    qs = (rows[:64] + 0.01).cpu().numpy()

    def answer(res):
        return [(r.id, r.distance) for r in res]
    graphs, db.index._q8 = db.index._q8, q8graph.Q8Graphs(db.index.device)
    want = {(i, k): answer(db.search(qs[i], k))
            for i in range(64) for k in (10, 5)}
    db.index._q8 = graphs
    before = _q8_counts()
    bad, errors = [], []

    def reader(t):
        try:
            for r in range(200):
                i, k = (t * 7 + r) % 64, (10, 5)[(t + r) % 2]
                if answer(db.search(qs[i], k)) != want[i, k]:
                    bad.append((t, r))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(repr(exc))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not bad, (errors, bad[:5])
    moved = {k: v - before[k] for k, v in _q8_counts().items()}
    assert moved["captures"] == 2 and moved["replays"] >= 790, moved
    db.close()


@pytest.mark.cuda
def test_q8_graph_replayed_b2_launches_seen_by_the_profiler(tmp_path):
    """A B2 launch replayed from a graph captured before the profiler
    started shows in the profiler's trace, one a replay, and each replay
    adds its launch to ``fused_int8_pool.launches`` (the traced run's
    launch check compares the two)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs)")
    import json

    from torch.profiler import ProfilerActivity, profile

    idx, rows = _q8_index("scan_pallas_int8", "l2")
    q = (rows[:1] + 0.01).cpu().numpy()
    idx.search_batch(q, 10)
    idx.search_batch(q, 10)  # captured here
    captures = _q8_counts()["captures"]
    before = tk.fused_int8_pool.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            idx.search_batch(q, 10)
        torch.cuda.synchronize()
    assert tk.fused_int8_pool.launches == before + 20
    assert _q8_counts()["captures"] == captures
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    seen = sum(1 for e in events if e.get("ph") == "X"
               and e.get("cat") == "kernel"
               and "pool_kernel" in e.get("name", ""))
    assert seen == 20, seen
