"""The host side of the pool kernels (``vector_db_torch/ops/kernels.py``)
that runs before any launch: the pass-split plan of ``_run_pool`` for the
s8 tile loop (64-query tiles) and the bf16 wgmma tile loop (128-query
tiles), and the bf16 row-width limit derived from the wgmma loop's
shared-memory layout.  CPU only; nothing here needs a card.
"""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from vector_db_torch.ops import kernels as tk  # noqa: E402

H100_SMS = 132
B6_N = 1_001_472   # the 1M store's bf16 shadow rows (scan_pallas)
B5_N = 524_288     # one adc_fast chunk (adc_pool="fused")


@pytest.mark.parametrize("qn,n,w,tile_q,want", [
    # B6 at its main shape: 16 x 8 = 128 tiles fill >= 90% of the SMs
    (1024, B6_N, 2048, tk.BF16_TILE_Q, 1),
    # few or part-filled tiles: ~2 waves of pass splits
    (129, B6_N, 2048, tk.BF16_TILE_Q, 8),
    (13, B6_N, 2048, tk.BF16_TILE_Q, 16),
    (1, B6_N, 2048, tk.BF16_TILE_Q, 16),
    # B5 over one chunk: 128 column tiles already fill the card
    (1024, B5_N, 16384, tk.BF16_TILE_Q, 1),
    (13, B5_N, 16384, tk.BF16_TILE_Q, 1),
    (1, B5_N, 16384, tk.BF16_TILE_Q, 1),
    # the s8 pools keep their plan (~4 blocks an SM)
    (1024, B6_N, 2048, tk.S8_TILE_Q, 3),
    (13, B6_N, 2048, tk.S8_TILE_Q, 33),
    (1, B6_N, 2048, tk.S8_TILE_Q, 33),
    # never more splits than passes, never fewer than one
    (1, 4000, 2048, tk.BF16_TILE_Q, 2),
    (1, 0, 2048, tk.BF16_TILE_Q, 1),
])
def test_pool_split_plan(qn, n, w, tile_q, want):
    assert tk.pool_splits(qn, n, w, H100_SMS, tile_q) == want


@pytest.mark.parametrize("qn", [1, 13, 129, 1024])
@pytest.mark.parametrize("tile_q", [tk.S8_TILE_Q, tk.BF16_TILE_Q])
def test_pool_splits_cover_every_pass(qn, tile_q):
    """Each split takes ceil(passes / splits) passes, so the splits cover
    every pass and none is empty past the last (the merge reads them in
    pass order)."""
    for n, w in [(B6_N, 2048), (B5_N, 16384), (5003, 384), (128, 128)]:
        passes = -(-n // w)
        sp = tk.pool_splits(qn, n, w, H100_SMS, tile_q)
        per = -(-passes // sp)
        assert 1 <= sp <= passes
        assert (sp - 1) * per < passes <= sp * per


def test_bf16_width_limit_follows_the_wgmma_tile_layout():
    """The widest bf16 row: the [128, d] query tile in 64-dim k-chunks of
    16 KB plus three 16 KB ring stages (the fewest the decode's hand-over
    needs), 2 KB of per-column values, 128 B of barriers and 1 KB of
    alignment within one H100 block's 232,448 bytes (csrc/pool_wgmma.cuh);
    it still takes every width the earlier kernel took (592)."""
    def smem(d, stages):
        return 1024 + (-(-d // 64) + stages) * 128 * 64 * 2 + 2048 + 128

    limit = tk.MAX_BF16_POOL_DIM
    assert limit == 640 and limit % 64 == 0 and limit >= 592
    assert smem(limit, 3) <= 232448 < smem(limit + 1, 3)
    tk._check_bf16_dim(592)
    tk._check_bf16_dim(limit)
    with pytest.raises(ValueError, match="shared memory"):
        tk._check_bf16_dim(limit + 1)


def _fake(shape, dtype):
    """A stand-in for a CUDA tensor: only the attributes the wrappers read
    before they build or launch anything."""
    return SimpleNamespace(shape=tuple(shape), ndim=len(shape), dtype=dtype,
                           device=torch.device("cuda"))


def test_too_wide_rows_raise_before_any_build_or_launch(monkeypatch):
    def no_build():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(tk.LIBRARY, "get", no_build)
    d = tk.MAX_BF16_POOL_DIM + 8
    n = 4096
    with pytest.raises(ValueError, match="shared memory"):
        tk.fused_raw_pool(_fake((4, d), torch.float32),
                          _fake((n, d), torch.bfloat16),
                          _fake((n,), torch.float32),
                          _fake((n,), torch.float32), 2048)
    s, sd, k = d // 8, 8, 256
    with pytest.raises(ValueError, match="shared memory"):
        tk.fused_adc_pool(_fake((4, s * sd), torch.float32),
                          _fake((s, n), torch.uint8),
                          _fake((s * sd, k), torch.float32),
                          _fake((n,), torch.float32), 2048)
