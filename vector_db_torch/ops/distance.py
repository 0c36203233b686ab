"""Pairwise distances and exact scans (the main-path subset of
``vector_db_tpu/ops/distance.py``).

All distances are **squared L2** or **cosine distance** (1 - cos
similarity); sqrt happens only at the API result boundary.  The products
are ``torch.matmul`` in float32 (TF32 stays off, PyTorch's default), and
every selection is an exact ``torch.topk`` where the reference used the
TPU's ``approx_max_k``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .topk import merge_topk, smallest_k

METRIC_L2 = "l2"
METRIC_COSINE = "cosine"
VALID_METRICS = (METRIC_L2, METRIC_COSINE)

#: largest [Q, N] f32 distance matrix blocked_knn_fast scores in one pass
FULL_ROW_BYTES = 512 * 1024 * 1024


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms. [N, d] -> [N]."""
    return torch.sum(x * x, dim=-1)


def normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rows scaled to unit L2 norm (cosine spaces hold normalized rows)."""
    n = torch.sqrt(torch.clamp(torch.sum(x * x, dim=-1, keepdim=True), min=eps))
    return x / n


def pairwise_sq_l2(q: torch.Tensor, base: torch.Tensor,
                   q_norms: Optional[torch.Tensor] = None,
                   b_norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[Q, N] squared L2 via ``(|q|^2 + |v|^2) - 2 q.v``, floored at 0.
    Two [Q, N] buffers at peak (the temporaries are updated in place)."""
    if q_norms is None:
        q_norms = sq_norms(q)
    if b_norms is None:
        b_norms = sq_norms(base)
    cross = q @ base.T
    d = q_norms[:, None] + b_norms[None, :]
    d.sub_(cross.mul_(2.0))
    return d.clamp_(min=0.0)


def pairwise_cosine_dist(q: torch.Tensor, base: torch.Tensor,
                         q_norms: Optional[torch.Tensor] = None,
                         b_norms: Optional[torch.Tensor] = None,
                         eps: float = 1e-12) -> torch.Tensor:
    """[Q, N] cosine distance ``1 - q.v / sqrt(max(|q|^2 |v|^2, eps))``."""
    if q_norms is None:
        q_norms = sq_norms(q)
    if b_norms is None:
        b_norms = sq_norms(base)
    cross = q @ base.T
    denom = (q_norms[:, None] * b_norms[None, :]).clamp_(min=eps).sqrt_()
    return cross.div_(denom).neg_().add_(1.0)


def pairwise_dist(q: torch.Tensor, base: torch.Tensor, metric: str = METRIC_L2,
                  q_norms: Optional[torch.Tensor] = None,
                  b_norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Metric-dispatching pairwise distance [Q, N]."""
    if metric == METRIC_L2:
        return pairwise_sq_l2(q, base, q_norms, b_norms)
    if metric == METRIC_COSINE:
        return pairwise_cosine_dist(q, base, q_norms, b_norms)
    raise ValueError(f"unknown metric {metric!r}; expected one of {VALID_METRICS}")


def _masked_dist(q, base, valid, metric, q_norms, b_norms):
    d = pairwise_dist(q, base, metric, q_norms, b_norms)
    return d.masked_fill_(~valid[None, :], float("inf"))


def blocked_knn(q: torch.Tensor, base: torch.Tensor, valid: torch.Tensor,
                k: int, metric: str = METRIC_L2,
                b_norms: Optional[torch.Tensor] = None,
                block_n: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN: blocks of ``block_n`` base rows with a running top-k
    merge, so no [Q, N] matrix exists.

    Returns (dists [Q, k], slot_idx [Q, k] int32) ascending; empty entries
    are +inf / -1.
    """
    qn, n = q.shape[0], base.shape[0]
    if b_norms is None:
        b_norms = sq_norms(base)
    q_norms = sq_norms(q)
    top_d = torch.full((qn, k), float("inf"), device=q.device)
    top_i = torch.full((qn, k), -1, dtype=torch.int32, device=q.device)
    for start in range(0, n, block_n):
        stop = min(start + block_n, n)
        d_blk = _masked_dist(q, base[start:stop], valid[start:stop], metric,
                             q_norms, b_norms[start:stop])
        i_blk = torch.arange(start, stop, dtype=torch.int32,
                             device=q.device).expand(qn, -1)
        top_d, top_i = merge_topk(top_d, top_i, d_blk, i_blk, k)
    return top_d, top_i


def blocked_knn_fast(q: torch.Tensor, base: torch.Tensor, valid: torch.Tensor,
                     k: int, metric: str = METRIC_L2,
                     b_norms: Optional[torch.Tensor] = None,
                     block_n: int = 32768) -> tuple[torch.Tensor, torch.Tensor]:
    """The flagship's exact scan: one full-row distance pass and one exact
    top-k when the [Q, N] f32 matrix is at most 512 MB, otherwise
    :func:`blocked_knn` over ``block_n``-row blocks.  Same contract as
    :func:`blocked_knn`.  (The reference's per-block ``approx_max_k`` has
    no CUDA counterpart; an exact ``torch.topk`` takes its place, so this
    scan is exact at every size.)"""
    qn, n = q.shape[0], base.shape[0]
    if qn * n * 4 > FULL_ROW_BYTES:
        return blocked_knn(q, base, valid, k, metric, b_norms, block_n)
    if b_norms is None:
        b_norms = sq_norms(base)
    return smallest_k(_masked_dist(q, base, valid, metric, sq_norms(q),
                                   b_norms), k)


def blocked_rerank(q: torch.Tensor, base: torch.Tensor, cand: torch.Tensor,
                   k: int, metric: str = METRIC_L2, rb: int = 512
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of [Q, R] candidate slots in column blocks of ``rb``
    with a running top-k merge — never the full [Q, R, d] gather.
    -1 candidates are ignored. Returns (dists [Q, k], slots [Q, k])
    ascending."""
    q_n, r = cand.shape
    rb = min(rb, max(128, -(-r // 128) * 128))
    q_norms = sq_norms(q)
    top_d = torch.full((q_n, k), float("inf"), device=q.device)
    top_i = torch.full((q_n, k), -1, dtype=cand.dtype, device=q.device)
    for start in range(0, r, rb):
        cnd = cand[:, start:start + rb]
        vecs = base[cnd.clamp(min=0).long()]                # [Q, rb, d]
        dots = torch.bmm(vecs, q[:, :, None])[:, :, 0]
        if metric == METRIC_L2:
            vn = torch.sum(vecs * vecs, dim=2)
            d = torch.clamp(q_norms[:, None] + vn - 2.0 * dots, min=0.0)
        else:
            qn = torch.sqrt(torch.clamp(q_norms, min=1e-12))[:, None]
            vn = torch.linalg.vector_norm(vecs, dim=2)
            d = 1.0 - dots / torch.clamp(qn * vn, min=1e-12)
        d = d.masked_fill_(cnd < 0, float("inf"))
        top_d, top_i = merge_topk(top_d, top_i, d, cnd, k)
    return top_d, top_i
