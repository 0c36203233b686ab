"""Masked top-k helpers (the counterpart of ``vector_db_tpu/ops/topk.py``).

Fixed-size sorted arrays merged with an exact ``torch.topk``; +inf entries
carry index -1.
"""

from __future__ import annotations

from typing import Optional

import torch


def smallest_k(dists: torch.Tensor, k: int,
               idx: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest along the last axis, ascending. Returns (dists,
    indices); ``idx`` is gathered instead of positional indices if given."""
    vals, arg = torch.topk(dists, k, dim=-1, largest=False, sorted=True)
    out_idx = (torch.gather(idx, -1, arg) if idx is not None
               else arg.to(torch.int32))
    out_idx = torch.where(torch.isfinite(vals), out_idx,
                          torch.full_like(out_idx, -1))
    return vals, out_idx


def merge_topk(d_a: torch.Tensor, i_a: torch.Tensor, d_b: torch.Tensor,
               i_b: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two (dist, idx) top-k sets along the last axis into one."""
    return smallest_k(torch.cat([d_a, d_b], dim=-1), k,
                      torch.cat([i_a, i_b], dim=-1))
