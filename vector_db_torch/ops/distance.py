"""Pairwise distances, exact scans, row packing and refines (the
counterpart of ``vector_db_tpu/ops/distance.py`` for the raw and the
compressed store).

All distances are **squared L2** or **cosine distance** (1 - cos
similarity); sqrt happens only at the API result boundary.  The products
are ``torch.matmul`` in float32 (TF32 stays off, PyTorch's default) on
every device: the reference's bf16 products in the refines are a TPU speed
choice, and its CPU path, which the tests compare with, is f32 too.  Every
selection is an exact ``torch.topk`` where the reference used the TPU's
``approx_max_k``.
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
#: bytes of the [Q, block, d] f32 rows one re-rank block gathers, where the
#: caller sizes its blocks by bytes (rerank_columns)
RERANK_BLOCK_BYTES = 1 << 28


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


def _bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, d] @ b [N, d]^T of bf16 values with f32 output: ``torch.mm``
    with bf16 inputs on the card; on the CPU the f32 product of the bf16
    values (each product exact in f32), as the reference's CPU backend."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.device.type == "cpu":
        return a16.to(torch.float32) @ b16.to(torch.float32).T
    return torch.mm(a16, b16.T, out_dtype=torch.float32)


def bf16_pool_scan(q: torch.Tensor, base: torch.Tensor, valid: torch.Tensor,
                   pool: int, metric: str = METRIC_L2,
                   b_norms: Optional[torch.Tensor] = None,
                   block_n: int = 0) -> torch.Tensor:
    """Candidate-pool selection over bf16 selection scores (the
    reference's ``ops/distance.bf16_pool_scan``, :264-403): returns slot
    indices [Q, pool] (-1 where empty) that should contain the true top-k;
    the caller re-ranks them exactly.

    The common mode is cancelled in f32 before the bf16 cast: queries are
    centered by the valid-weighted mean ``mu`` of the first 4096 slots (the
    unit mean direction under cosine), the centering vector rides the bf16
    product as two extra query rows (its bf16 value and the bf16 of the
    rest, so ``c . v`` keeps ~16 bits), and the score is assembled as
    ``(||v - mu||^2 - E||v - mu||^2) - 2 (q - mu).(v - mu)`` under L2, or
    ``-(cos(q, v) - c0)`` under cosine, then cast to bf16.  The product is
    :func:`_bf16_mm`; the selects are exact ``torch.topk`` (on the bf16
    scores) where the reference used ``approx_max_k``.  ``block_n`` in
    (0, N) streams blocks of that many rows with a running top-``pool``
    merge; the last block is re-sliced to end at N and masks the rows
    earlier blocks covered (padding would copy the corpus).
    """
    qn, n = q.shape[0], base.shape[0]
    if b_norms is None:
        b_norms = sq_norms(base)
    if metric == METRIC_COSINE:
        q = normalize_rows(q)
    m = min(4096, n)
    pref = base[:m]
    w = valid[:m].to(torch.float32)
    wsum = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(pref * w[:, None], dim=0) / wsum
    musq = torch.sum(mu * mu)
    if metric == METRIC_COSINE:
        c = mu * torch.rsqrt(torch.clamp(musq, min=1e-12))
        pn = torch.sqrt(torch.clamp(torch.sum(pref * pref, dim=1), min=1e-12))
        c0 = torch.sum((pref @ c) / pn * w) / wsum
    else:
        c = mu
        live = torch.clamp(torch.sum(valid.to(torch.float32)), min=1.0)
        mean_norm = torch.sum(torch.where(valid, b_norms, 0.0)) / live
        center = mean_norm - musq
    qc = q - c[None, :]
    c_hi = c.to(torch.bfloat16).to(torch.float32)
    extra = torch.zeros(((-qn - 2) % 8, q.shape[1]), device=q.device)
    qaug = torch.cat([qc, c_hi[None, :], (c - c_hi)[None, :], extra])
    qmu = qc @ c                                   # [Q] per-query constants

    def block_scores(b_blk, n_blk, v_blk):
        cross = _bf16_mm(qaug, b_blk)
        cv = cross[qn] + cross[qn + 1]             # c . v (hi + lo)
        if metric == METRIC_COSINE:
            iv = torch.rsqrt(torch.clamp(n_blk, min=1e-12))
            s = -((cross[:qn] + cv[None, :]) * iv[None, :] - c0)
        else:
            vhat_sq = n_blk + musq - 2.0 * cv - center
            s = vhat_sq[None, :] - 2.0 * (cross[:qn] - qmu[:, None])
        return s.to(torch.bfloat16).masked_fill_(~v_blk[None, :],
                                                 float("inf"))

    if block_n <= 0 or block_n >= n:
        vals, cand = torch.topk(block_scores(base, b_norms, valid), pool,
                                dim=1, largest=False, sorted=True)
        cand = cand.to(torch.int32)
        return torch.where(torch.isfinite(vals), cand, torch.full_like(cand, -1))
    top_v = torch.full((qn, pool), float("inf"), device=q.device)
    top_i = torch.full((qn, pool), -1, dtype=torch.int32, device=q.device)
    for b in range(-(-n // block_n)):
        start = min(b * block_n, n - block_n)
        sl = slice(start, start + block_n)
        live = valid[sl].clone()
        live[:b * block_n - start] = False  # covered by earlier blocks
        vals, idx = torch.topk(block_scores(base[sl], b_norms[sl], live),
                               pool, dim=1, largest=False, sorted=True)
        top_v, top_i = merge_topk(top_v, top_i, vals.to(torch.float32),
                                  idx.to(torch.int32) + start, pool)
    return top_i


def rerank_columns(q_n: int, dim: int, least: int = 1) -> int:
    """Candidate columns a re-rank block of ``q_n`` queries holds under
    RERANK_BLOCK_BYTES of gathered f32 rows, and at least ``least``: a
    small batch takes few wide blocks (few launches), a large one the
    caller's usual width."""
    return max(least, RERANK_BLOCK_BYTES // max(1, 4 * q_n * dim))


def blocked_rerank(q: torch.Tensor, base: torch.Tensor, cand: torch.Tensor,
                   k: int, metric: str = METRIC_L2, rb: int = 512
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of [Q, R] candidate slots in column blocks of ``rb``
    with a running top-k merge — never the full [Q, R, d] gather.  ``base``
    is the f32 store or a bf16 refine store (:func:`pack_bf16_rows`, the
    reference's ``blocked_rerank_packed``): rows are gathered in their own
    type and scored in f32.  -1 candidates are ignored.  Returns (dists
    [Q, k], slots [Q, k]) ascending."""
    def score(safe):
        v = base[safe].to(torch.float32)                     # [Q, rb, d]
        return torch.bmm(v, q[:, :, None])[:, :, 0], torch.sum(v * v, dim=2)
    return _rerank_blocks(q, cand, k, metric, rb, score)


# ------------------------------------------------------ packed row stores
def pack_bf16_rows(base: torch.Tensor) -> torch.Tensor:
    """[N, d] f32 -> [N, d] bf16 refine store for :func:`blocked_rerank`.
    The reference packs bf16 pairs into f32 words because bf16 gathers are
    slow on its TPU; the values are the same, so the port keeps a plain
    bf16 tensor."""
    return base.to(torch.bfloat16)


def pack_int8_rows(base: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, d] f32 -> (int32-packed int8 rows [N, d/4], per-row scales [N]).

    Symmetric per-row quantization: scale = max(max|v|, 1e-30) / 127 and
    row8 = clip(round-half-even(v / scale), -127, 127).  Four int8 dims
    share one int32 word, little-endian: byte j of word c is dim 4c + j,
    which is what ``.view(torch.int32)`` of the contiguous [N, d/4, 4]
    bytes gives (the same words as the reference's
    ``bitcast_convert_type``).  Requires d % 4 == 0.
    """
    n, d = base.shape
    amax = torch.clamp(torch.amax(torch.abs(base), dim=1), min=1e-30)
    # a true division on every device (CUDA divides by a Python scalar as
    # a product with its reciprocal, one ulp off numpy's amax / 127)
    scale = amax / torch.full_like(amax, 127.0)
    q8 = torch.clamp(torch.round(base / scale[:, None]), -127, 127
                     ).to(torch.int8)
    return q8.reshape(n, d // 4, 4).view(torch.int32).reshape(n, d // 4), scale


def words_to_f32(words: torch.Tensor) -> torch.Tensor:
    """int32 words [..., d/4] -> their int8 values as f32 [..., d]."""
    shape = words.shape
    return words.contiguous().view(torch.int8).reshape(
        *shape[:-1], 4 * shape[-1]).to(torch.float32)


def unpack_int8_rows(packed: torch.Tensor, scales: torch.Tensor
                     ) -> torch.Tensor:
    """Inverse of :func:`pack_int8_rows` up to quantization: [N, d/4]
    int32 + [N] scales -> [N, d] f32 dequantized rows."""
    return words_to_f32(packed) * scales[:, None]


def pack_int8_residual(base: torch.Tensor, packed: torch.Tensor,
                       scales: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Second-level int8 quantization of the rows' residual
    ``base - unpack(packed)``: (resid [N, d/4] int32, rscales [N]).  The
    two levels together hold ~16-bit precision at half the bytes of f32.
    The residual is one fused multiply-add (rounded once), as XLA fuses
    the reference's ``base - v8 * scale``: the residual is ~1/254 of the
    row, so a second rounding would move its scale by ~1e-5."""
    return pack_int8_rows(torch.addcmul(base, words_to_f32(packed),
                                        scales[:, None], value=-1.0))


def _int8_dots_norms(q, v8, sc, r8, rsc, vn, metric, dots_fn):
    """Cross terms and squared row norms of int8 rows, in the reference's
    order: the int8 product is scaled after the dot, plus the residual
    level's; the norms are the exact ``vn`` under L2 when given, else the
    two-level row's own (with a residual) or ``sum(v8^2) * sc^2``."""
    dots = dots_fn(q, v8) * sc
    if r8 is not None:
        dots = dots + dots_fn(q, r8) * rsc
    if vn is None or metric != METRIC_L2:
        if r8 is not None:
            deq = v8 * sc[..., None] + r8 * rsc[..., None]
            vn = torch.sum(deq * deq, dim=-1)
        else:
            vn = torch.sum(v8 * v8, dim=-1) * (sc * sc)
    return dots, vn


def blocked_rerank_int8(q: torch.Tensor, packed: torch.Tensor,
                        scales: torch.Tensor, cand: torch.Tensor, k: int,
                        metric: str = METRIC_L2, rb: int = 512,
                        b_norms: Optional[torch.Tensor] = None,
                        resid: Optional[torch.Tensor] = None,
                        rscales: Optional[torch.Tensor] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`blocked_rerank` against an int8 row store
    (:func:`pack_int8_rows`), dots in f32.

    ``b_norms`` (the exact squared norms the compressed store captures at
    write time) is the row norm under L2, so only the cross term carries
    quantization error.  Under cosine the quantized row's own norm is the
    denominator (the exact cosine to the quantized direction), with or
    without ``b_norms``.  ``resid``/``rscales`` (:func:`pack_int8_residual`)
    add the second level to the cross term and to the cosine norm."""
    def bdots(qq, v):
        return torch.bmm(v, qq[:, :, None])[:, :, 0]

    def score(safe):
        return _int8_dots_norms(
            q, words_to_f32(packed[safe]), scales[safe],
            None if resid is None else words_to_f32(resid[safe]),
            None if resid is None else rscales[safe],
            None if b_norms is None else b_norms[safe], metric, bdots)
    return _rerank_blocks(q, cand, k, metric, rb, score)


def _rerank_blocks(q, cand, k, metric, rb, score):
    """The shared loop of the store refines: candidate column blocks of
    ``rb`` (never the whole [Q, R, d] gather), each scored and merged into
    a running exact top-k.  ``score(safe)`` returns the cross terms and the
    squared row norms [Q, rb] of the gathered slots."""
    q_n, r = cand.shape
    rb = min(rb, max(128, -(-r // 128) * 128))
    q_norms = sq_norms(q)
    top_d = torch.full((q_n, k), float("inf"), device=q.device)
    top_i = torch.full((q_n, k), -1, dtype=cand.dtype, device=q.device)
    for start in range(0, r, rb):
        cnd = cand[:, start:start + rb]
        dots, vn = score(cnd.clamp(min=0).long())
        d = _dist_from_terms(q_norms[:, None], vn, dots, metric)
        d = d.masked_fill_(cnd < 0, float("inf"))
        top_d, top_i = merge_topk(top_d, top_i, d, cnd, k)
    return top_d, top_i


def _dist_from_terms(q_norms, vn, dots, metric):
    """Squared L2 or cosine distance from |q|^2, |v|^2 and q.v."""
    if metric == METRIC_L2:
        return torch.clamp(q_norms + vn - 2.0 * dots, min=0.0)
    qn = torch.sqrt(torch.clamp(q_norms, min=1e-12))
    return 1.0 - dots / torch.clamp(qn * torch.sqrt(vn), min=1e-12)


def blocked_knn_int8(q: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor, valid: torch.Tensor, k: int,
                     metric: str = METRIC_L2,
                     b_norms: Optional[torch.Tensor] = None,
                     block_n: int = 262144,
                     resid: Optional[torch.Tensor] = None,
                     rscales: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN over an int8 row store (the compressed tier's exhaustive
    scan): f32 products of the int8 rows (plus the residual level), the
    norm term exact from ``b_norms`` under L2, and a running exact top-k
    (the reference's per-block ``approx_max_k`` becomes ``torch.topk``).

    Blocks of ``block_n`` rows; the last block is re-sliced to end at N and
    masks the rows earlier blocks covered (padding would copy the store).
    Returns (dists [Q, k], slots [Q, k] int32) ascending; +inf / -1 padded.
    """
    qn, n = q.shape[0], packed.shape[0]
    q_norms = sq_norms(q)
    top_d = torch.full((qn, k), float("inf"), device=q.device)
    top_i = torch.full((qn, k), -1, dtype=torch.int32, device=q.device)
    block_n = min(block_n, n)
    for b in range(-(-n // block_n)):
        start = min(b * block_n, n - block_n)
        sl = slice(start, start + block_n)
        dots, vn = _int8_dots_norms(
            q, words_to_f32(packed[sl]), scales[sl][None, :],
            None if resid is None else words_to_f32(resid[sl]),
            None if resid is None else rscales[sl][None, :],
            None if b_norms is None else b_norms[sl][None, :], metric,
            lambda qq, v: qq @ v.T)
        d = _dist_from_terms(q_norms[:, None], vn, dots, metric)
        live = valid[sl].clone()
        live[:b * block_n - start] = False  # covered by earlier blocks
        d = d.masked_fill_(~live[None, :], float("inf"))
        idx = torch.arange(start, start + block_n, dtype=torch.int32,
                           device=q.device).expand(qn, -1)
        top_d, top_i = merge_topk(top_d, top_i, d, idx, k)
    return top_d, top_i
