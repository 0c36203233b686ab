"""The host side of the pool kernels (``vector_db_torch/ops/kernels.py``)
that runs before any launch: the pass-split plan of ``_run_pool`` for the
wgmma tile loop (128-query tiles; the bf16 and the s8 pools alike), the
ring depth and query-tile layout (resident or streamed) derived from that
loop's shared-memory arithmetic, the cluster scan's plan (blocks, bucket
split, ring), and that rows of any width reach the kernel library.  CPU
only; nothing here needs a card.
"""

import pytest

torch = pytest.importorskip("torch")

from vector_db_torch.ops import kernels as tk  # noqa: E402

H100_SMS = 132
B6_N = 1_001_472   # the 1M store's shadow rows (scan_pallas, scan_pallas_int8)
B5_N = 524_288     # one adc_fast chunk (adc_pool="fused")


@pytest.mark.parametrize("qn,n,w,want", [
    # B6 at its main shape: 16 x 8 = 128 tiles fill >= 90% of the SMs
    (1024, B6_N, 2048, 1),
    # two query tiles, the second part-filled: ~2 waves of pass splits
    (129, B6_N, 2048, 8),
    # one query tile: one wave of alike blocks
    (13, B6_N, 2048, 8),
    (1, B6_N, 2048, 8),
    # B5 over one chunk: 128 column tiles already fill the card
    (1024, B5_N, 16384, 1),
    (13, B5_N, 16384, 1),
    (1, B5_N, 16384, 1),
    # the s8 pools (B2, B4, B7) at the 1M shape: the same 128-query tiles
    (1024, B6_N, 4096, 1),
    (13, B6_N, 512, 33),
    (1, B6_N, 256, 66),
    (200, B6_N, 512, 33),  # 2 x 4 tiles: ~2 waves
    # never more splits than passes, never fewer than one
    (1, 4000, 2048, 2),
])
def test_pool_split_plan(qn, n, w, want):
    assert tk.pool_splits(qn, n, w, H100_SMS) == want
    assert tk.pool_splits(qn, 0, w, H100_SMS) == 1  # no pass: one split


@pytest.mark.parametrize("qn", [1, 13, 129, 1024])
@pytest.mark.parametrize("sms", [H100_SMS, 114])  # H100 SXM, H100 PCIe
def test_pool_splits_cover_every_pass(qn, sms):
    """Each split takes ceil(passes / splits) passes, so the splits cover
    every pass and none is empty past the last (the merge reads them in
    pass order)."""
    for n, w in [(B6_N, 2048), (B5_N, 16384), (5003, 384), (128, 128)]:
        passes = -(-n // w)
        sp = tk.pool_splits(qn, n, w, sms)
        per = -(-passes // sp)
        assert 1 <= sp <= passes
        assert (sp - 1) * per < passes <= sp * per


def _smem(row_bytes, stages, streamed):
    """One block of csrc/pool_wgmma.cuh, counted here independently: 1 KB of
    alignment, 16 KB k-chunks of [128 rows x 128 bytes] (the query tile's
    ceil(row_bytes / 128), or one query slab a stage when streamed, beside
    each stage's corpus chunk), 2 KB of per-column values, 256 B of
    barriers."""
    q_chunks = stages if streamed else -(-row_bytes // 128)
    return 1024 + (q_chunks + stages) * 128 * 128 + 2048 + 256


@pytest.mark.parametrize("d,elem,max_stages,want", [
    # bf16 (2 bytes a dim), a four-stage ring
    (512, 2, tk.BF16_POOL_STAGES, (4, False)),
    (576, 2, tk.BF16_POOL_STAGES, (4, False)),
    (640, 2, tk.BF16_POOL_STAGES, (3, False)),   # the widest resident
    (704, 2, tk.BF16_POOL_STAGES, (4, True)),
    (768, 2, tk.BF16_POOL_STAGES, (4, True)),
    (1536, 2, tk.BF16_POOL_STAGES, (4, True)),
    # s8 (1 byte a dim): half the query tile, room for a deeper ring
    (512, 1, 9, (9, False)),
    (516, 1, 9, (8, False)),
    (1280, 1, 9, (3, False)),                    # the widest resident
    (1408, 1, 9, (6, True)),
    (1536, 1, 9, (6, True)),
    (4096, 1, 9, (6, True)),
])
def test_wgmma_plan_follows_the_shared_memory_layout(d, elem, max_stages,
                                                     want):
    """The query tile stays resident while it and three stages fit one
    H100 block's 232,448 bytes, with as many stages as fit up to the
    ring's depth; past that every stage streams its query slab, and any
    width fits."""
    stages, streamed = tk.wgmma_plan(d * elem, max_stages)
    assert (stages, streamed) == want
    assert 3 <= stages <= max_stages
    assert _smem(d * elem, stages, streamed) <= 232448
    fits_resident = _smem(d * elem, 3, False) <= 232448
    assert streamed == (not fits_resident)
    if not streamed and stages < max_stages:  # one more stage would not fit
        assert _smem(d * elem, stages + 1, False) > 232448


# ------------------------------------------------ the cluster scan's plan
GRID_1M = (513, 2688)     # nlist, cap of the 1M scan_ivf grid
GRID_10M = (4865, 2688)   # ... of a 9,962,496-slot store


@pytest.mark.parametrize("grid,p_cap,q_n,want_tiles,want_splits", [
    # Q=1024, nprobe 64: more live (cluster, tile) pairs than SMs, no split
    (GRID_1M, 512, 1024, 513 + 512, 1),
    (GRID_10M, 64, 1024, 4865, 1),
    # Q=1: at most 64 clusters, one tile each; 2 x 64 blocks, one wave
    (GRID_1M, 32, 1, 64, 2),
    (GRID_10M, 32, 1, 64, 2),
    (GRID_1M, 32, 2, 129, 1),
    # no probe count: every pair gets a block
    (GRID_1M, 512, None, 513 * 4, 1),
    (GRID_10M, 64, None, 4865, 1),
    # a bucket a cluster cannot be split; 32 buckets over 4 blocks each
    ((64, 128), 64, 1, 64, 1),
    ((16, 4096), 160, None, 32, 4),
    ((8, 2688), 32, 1, 8, 11),     # 16 splits wanted: 2 buckets each, 11
])
@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_ivf_pool_plan_fills_the_card(grid, p_cap, q_n, want_tiles,
                                      want_splits, sms):
    """One block a (cluster, 128-prober tile) pair, bounded by the batch's
    probes where the caller knows them; when those blocks leave more than
    half of the SMs idle, each cluster's buckets are split over as many
    blocks as still run in one wave, every bucket in exactly one split."""
    nlist, cap = grid
    probes = None if q_n is None else q_n * 64
    plan = tk.ivf_pool_plan(nlist, cap, p_cap, 512, sms, probes)
    assert plan.tile_rows == 128 and plan.tiles == want_tiles
    if sms == H100_SMS:
        assert plan.splits == want_splits
    buckets = cap // 128
    assert 1 <= plan.splits <= buckets
    if 2 * plan.tiles > sms:
        assert plan.splits == 1
    else:
        assert plan.splits >= 2 or buckets == 1
        assert plan.splits * plan.tiles <= sms          # one wave
    covered = [b for y in range(plan.splits)
               for b in range(y * plan.buckets_per_split,
                              min(buckets, (y + 1) * plan.buckets_per_split))]
    assert covered == list(range(buckets))          # each bucket once
    assert (plan.splits - 1) * plan.buckets_per_split < buckets  # none empty


@pytest.mark.parametrize("seed", range(4))
def test_ivf_pool_plan_has_a_block_for_every_live_pair(seed):
    """Whatever the prober counts of a batch of `probes` probes, the live
    (cluster, tile) pairs fit the planned blocks."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nlist, cap = GRID_1M
    for q_n, p_cap in [(1, 32), (7, 32), (100, 64), (1024, 512)]:
        probes = q_n * 64
        hit = rng.choice(nlist, probes) if seed % 2 else rng.choice(
            max(1, nlist // 16), probes)        # spread, or piled up
        counts = np.minimum(np.bincount(hit, minlength=nlist), p_cap)
        live = int((-(-counts // 128)).sum())
        plan = tk.ivf_pool_plan(nlist, cap, p_cap, 512, H100_SMS, probes)
        assert live <= plan.tiles <= nlist * -(-p_cap // 128)


@pytest.mark.parametrize("d,want", [
    (32, (9, False)), (512, (9, False)), (516, (8, False)),
    (768, (7, False)), (1024, (5, False)), (1280, (3, False)),
    (1408, (6, True)), (1536, (6, True)), (4096, (6, True)),
])
def test_ivf_pool_plan_follows_the_shared_memory_layout(d, want):
    """The cluster scan's ring: the prober tile resident beside up to nine
    stages while three fit, streamed past that; within one H100 block's
    shared memory at every width."""
    plan = tk.ivf_pool_plan(513, 2688, 512, d, H100_SMS, 65536)
    assert (plan.stages, plan.streamed) == want
    assert plan.stages >= 3
    assert _smem(d, plan.stages, plan.streamed) <= 232448
    assert plan.streamed == (_smem(d, 3, False) > 232448)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so a wrapper takes its card
    path (the results of its operations report it too)."""

    @property
    def device(self):
        return torch.device("cuda")


class _Reached(Exception):
    pass


def _card(x):
    return x.as_subclass(_OnCard)


def _wide_calls(d):
    """One call of each pool at rows of d dims, on card-reporting tensors."""
    g = torch.Generator().manual_seed(d)
    n, qn = 4096, 4
    q = _card(torch.randn(qn, d, generator=g))
    f32 = lambda m: _card(torch.rand(m, generator=g))  # noqa: E731
    b8 = _card(torch.randint(-127, 128, (n, d), generator=g,
                             dtype=torch.int8))
    s, sd, k = d // 8, 8, 256
    p_cap, cap, nlist = 64, 256, 4
    return {
        "fused_int8_pool": lambda: tk.fused_int8_pool(q, b8, f32(n), f32(n),
                                                      2048),
        "fused_packed_pool": lambda: tk.fused_packed_pool(
            q, b8.view(torch.int32), f32(n), f32(n), 2048),
        "fused_int8g_pool": lambda: tk.fused_int8g_pool(
            q, b8, f32(n), torch.tensor(0.01), 2.0, 2048),
        "fused_raw_pool": lambda: tk.fused_raw_pool(
            q, b8.to(torch.bfloat16), f32(n), f32(n), 2048),
        "fused_adc_pool": lambda: tk.fused_adc_pool(
            q, _card(torch.randint(0, k, (s, n), generator=g,
                                   dtype=torch.uint8)),
            _card(torch.randn(s * sd, k, generator=g)), f32(n), 2048),
        "fused_ivf_pool": lambda: tk.fused_ivf_pool(
            _card(torch.full((nlist,), 3, dtype=torch.int32)),
            b8[:nlist * p_cap].view(torch.int32),
            b8[:nlist * cap].view(torch.int32), f32(nlist * cap),
            f32(nlist * cap), nlist, cap, p_cap, 2),
    }


@pytest.mark.parametrize("pool", ["fused_int8_pool", "fused_packed_pool",
                                  "fused_int8g_pool", "fused_raw_pool",
                                  "fused_adc_pool", "fused_ivf_pool"])
@pytest.mark.parametrize("d", [1536, 1544])
def test_wide_rows_reach_the_kernel_library(monkeypatch, pool, d):
    """No pool refuses a row width the reference takes: on the card path a
    call with rows of 1536 (or 1544: not whole 128-byte chunks) dims gets
    past every check to the kernel library (here a stand-in that stops
    the call)."""
    def reached():
        raise _Reached

    monkeypatch.setattr(tk.LIBRARY, "get", reached)
    with pytest.raises(_Reached):
        _wide_calls(d)[pool]()


def test_rows_past_the_int32_range_raise():
    """The one width limit left: the s8 cross term must fit int32."""
    d = tk.MAX_INT8_DIM
    assert 127 ** 2 * d < 2 ** 31 <= 127 ** 2 * (d + 1)
    tk._check_s32_range(d)
    with pytest.raises(ValueError, match="int32"):
        tk._check_s32_range(d + 1)
