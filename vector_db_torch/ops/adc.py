"""Product quantization: encode, the distance-table scans and the fast
codes-only scoring pipeline (the counterpart of ``vector_db_tpu/ops/adc.py``).

``build_distance_tables`` gives each query its [S, K] table of subspace
distances; ``adc_scan_topk`` scans the [N, S] codes against the tables in
blocks with a running exact top-k, reducing a block by a gather or by a
one-hot product (bf16 inputs, f32 output), and ``adc_decode_topk`` ranks
the same ADC distances from the decode kernel's reconstruction.

``adc_fast_search`` decodes the codes with the PQ decode kernel
(``ops/kernels.pq_decode_recon_t``), scores the queries against the
reconstruction with one matrix product, keeps an unranked or ranked pool,
and re-ranks the pool against a refine store; with ``pool_mode="fused"``
one kernel (``ops/kernels.fused_adc_pool``) decodes, scores and pools.
The selections are exact ``torch.topk`` where the reference used
``approx_max_k``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.stats import GLOBAL, span
from .distance import (_bf16_mm, blocked_rerank, blocked_rerank_int8,
                       normalize_rows)
from .kernels import fused_adc_pool, pq_decode_recon_t
from .topk import merge_topk, smallest_k

#: bytes of the [S, rows, K] f32 distance block one pq_encode chunk holds
ENCODE_CHUNK_BYTES = 1 << 30


def pq_encode(data: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Encode vectors to PQ codes: data [n, dim], codebooks [S, K, sub_dim]
    -> codes [n, S] uint8, the per-subspace nearest centroid.

    Rows go in chunks sized so the [S, rows, K] distance block stays under
    ``ENCODE_CHUNK_BYTES`` (the reference chunks by a fixed 2^18 rows, which is
    17 GB of distances at S=64, K=256).
    """
    n, dim = data.shape
    s, k, sub_dim = codebooks.shape
    cb_norms = torch.sum(codebooks * codebooks, dim=2)            # [S, K]
    rows = max(1, ENCODE_CHUNK_BYTES // (4 * s * k))
    codes = torch.empty((n, s), dtype=torch.uint8, device=data.device)
    for start in range(0, n, rows):
        sub = data[start:start + rows].reshape(-1, s, sub_dim).transpose(0, 1)
        d = torch.sum(sub * sub, dim=2)[:, :, None] + cb_norms[:, None, :]
        d.sub_(torch.bmm(sub, codebooks.transpose(1, 2)).mul_(2.0))
        codes[start:start + rows] = torch.argmin(d, dim=2).T.to(torch.uint8)
    return codes


def build_distance_tables(queries: torch.Tensor, codebooks: torch.Tensor
                          ) -> torch.Tensor:
    """Per-query subspace distance tables: queries [Q, dim], codebooks
    [S, K, sub_dim] -> tables [Q, S, K] f32 with tables[q, s, c] =
    ||q_sub[s] - codebooks[s, c]||^2."""
    q_n = queries.shape[0]
    s, _, sub_dim = codebooks.shape
    q_sub = queries.reshape(q_n, s, sub_dim)
    cb_norms = torch.sum(codebooks * codebooks, dim=2)            # [S, K]
    q_norms = torch.sum(q_sub * q_sub, dim=2)                     # [Q, S]
    cross = torch.bmm(q_sub.transpose(0, 1), codebooks.transpose(1, 2)
                      ).transpose(0, 1)                           # [Q, S, K]
    return q_norms[:, :, None] + cb_norms[None, :, :] - 2.0 * cross


def _adc_block_gather(tables: torch.Tensor, codes_blk: torch.Tensor
                      ) -> torch.Tensor:
    """Distances of one code block by gather: tables [Q, S, K], codes
    [B, S] -> [Q, B]."""
    idx = codes_blk.long().T[None, :, :].expand(tables.shape[0], -1, -1)
    return torch.sum(torch.gather(tables, 2, idx), dim=1)


def _adc_block_onehot(tables: torch.Tensor, codes_blk: torch.Tensor
                      ) -> torch.Tensor:
    """Distances of one code block by a one-hot product: the tables are
    rounded to bf16 (the reference's arithmetic under ``impl="onehot"``),
    the [B, S*K] one-hot matrix is exact, and the product accumulates in
    f32.  tables [Q, S, K], codes [B, S] -> [Q, B]."""
    q_n, s, k = tables.shape
    b = codes_blk.shape[0]
    col = codes_blk.long() + torch.arange(s, device=tables.device)[None] * k
    onehot = torch.zeros((b, s * k), dtype=torch.bfloat16,
                         device=tables.device).scatter_(1, col, 1.0)
    return _bf16_mm(tables.reshape(q_n, s * k), onehot)


def adc_scan_topk(tables: torch.Tensor, codes: torch.Tensor,
                  valid: torch.Tensor, k: int, block_n: int = 4096,
                  impl: str = "gather") -> tuple[torch.Tensor, torch.Tensor]:
    """Exhaustive ADC scan with a running exact top-k over blocks of
    ``block_n`` codes (the last block may be short: nothing is padded).

    tables [Q, S, K]; codes [N, S] uint8; valid [N] bool.  Returns (dists
    [Q, k], slots [Q, k] int32) ascending; +inf / -1 where empty.
    """
    q_n, n = tables.shape[0], codes.shape[0]
    block_fn = _adc_block_gather if impl == "gather" else _adc_block_onehot
    dev = tables.device
    top_d = torch.full((q_n, k), float("inf"), device=dev)
    top_i = torch.full((q_n, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, n, block_n):
        stop = min(start + block_n, n)
        d_blk = block_fn(tables, codes[start:stop])
        d_blk = d_blk.masked_fill_(~valid[None, start:stop], float("inf"))
        i_blk = torch.arange(start, stop, dtype=torch.int32,
                             device=dev).expand(q_n, -1)
        top_d, top_i = merge_topk(top_d, top_i, d_blk, i_blk, k)
    return top_d, top_i


def adc_distances(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Full [Q, N] ADC distance matrix (small N, or single pairs)."""
    return _adc_block_gather(tables, codes)


def balanced_subspace_perm(variances, num_subspaces: int) -> np.ndarray:
    """Variance-balanced dimension permutation for PQ subspaces (host
    numpy, a copy of the reference's): dims in descending variance go to
    the least-loaded subspace with room, equalising per-subspace variance.

    Returns perm [d] — position j of the permuted vector takes original
    dim perm[j]; subspace s owns positions [s*sd, (s+1)*sd).
    """
    v = np.asarray(variances, np.float64)
    d = v.shape[0]
    sd = d // num_subspaces
    order = np.argsort(-v, kind="stable")
    totals = np.zeros(num_subspaces)
    members: list[list[int]] = [[] for _ in range(num_subspaces)]
    for dim in order:
        open_s = [s for s in range(num_subspaces) if len(members[s]) < sd]
        s = min(open_s, key=lambda s: (totals[s], s))
        members[s].append(int(dim))
        totals[s] += v[dim]
    return np.concatenate([np.asarray(m, np.int64) for m in members])


def codebooks_to_cbt(codebooks: torch.Tensor) -> torch.Tensor:
    """[S, K, sd] -> the decode kernel's [S*sd, K] gather layout."""
    s, k, sd = codebooks.shape
    return codebooks.permute(0, 2, 1).reshape(s * sd, k).contiguous()


def scan_dtype(device: torch.device) -> torch.dtype:
    """The scoring product's input type: bf16 on the card (f32
    accumulation, as the reference on its TPU), f32 on the CPU (as the
    reference's CPU backend, which the tests compare with)."""
    return torch.float32 if device.type == "cpu" else torch.bfloat16


def code_norms_from_codes(codes_t: torch.Tensor, cbt: torch.Tensor,
                          valid: torch.Tensor,
                          code_norms: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """[N] squared reconstruction norms with +inf at dead slots; a cached
    ``code_norms`` skips the decode pass."""
    if code_norms is None:
        r32 = pq_decode_recon_t(codes_t, cbt).to(torch.float32)
        code_norms = torch.sum(r32 * r32, dim=0)
    return torch.where(valid, code_norms, float("inf"))


def adc_decode_topk(queries: torch.Tensor, codes_t: torch.Tensor,
                    cbt: torch.Tensor, valid: torch.Tensor, k: int,
                    code_norms: Optional[torch.Tensor] = None,
                    perm: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ranked ADC top-k through the decode kernel: decode, one product
    (:func:`_decode_cross`), an exact top-k.  Returns the ADC distances
    |q - reconstruction|^2 (query norm added back, floored at 0),
    ascending, with slots [Q, k] int32; +inf / -1 where empty.  The same
    distances as :func:`adc_scan_topk` up to the bf16 rounding of the
    reconstruction and the queries."""
    masked = code_norms_from_codes(codes_t, cbt, valid, code_norms)
    if perm is not None:
        queries = queries[:, perm]
    cross = _decode_cross(
        queries.to(scan_dtype(queries.device)).contiguous(), codes_t, cbt)
    q_norms = torch.sum(queries * queries, dim=1)
    dist = torch.add(q_norms[:, None] + masked[None, :], cross, alpha=-2.0)
    vals, idx = smallest_k(dist, k)
    return vals.clamp_(min=0.0), idx


def _decode_cross(qb: torch.Tensor, codes_t: torch.Tensor,
                  cbt: torch.Tensor) -> torch.Tensor:
    """q . reconstruction cross terms [Q, n] f32: the decode kernel's bf16
    [d, n] reconstruction, then one product with f32 output (bf16 inputs on
    the card, ``torch.mm(..., out_dtype=torch.float32)``; f32 on the CPU)."""
    recon_t = pq_decode_recon_t(codes_t, cbt)                   # [d, n] bf16
    if qb.dtype == torch.float32:
        return qb @ recon_t.to(torch.float32)
    return torch.mm(qb, recon_t, out_dtype=torch.float32)


def _score_pool_chunk(qb: torch.Tensor, codes_t: torch.Tensor,
                      cbt: torch.Tensor, masked_norms: torch.Tensor,
                      bucket: int, winners: int, pool_mode: str = "bucket"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Score one corpus chunk from its codes and return its candidate pool
    (values, local slots, -1 where empty):

      * ``"bucket"``: the best ``winners`` of each strided bucket (slot i
        joins bucket i % nb), unranked, pool = winners * ceil(n / bucket);
      * ``"approx"``: a ranked top-``winners * nb`` (exact ``torch.topk``
        where the reference used ``approx_max_k``);
      * ``"fused"``: the strided min pool of width ``winners * nb`` (rounded
        by ``ops/kernels.pool_width``) from ``ops/kernels.fused_adc_pool``.
    """
    q_n, n = qb.shape[0], codes_t.shape[1]
    if pool_mode == "fused":
        # one kernel: decode + product + bucket min, neither the [d, n]
        # reconstruction nor the [Q, n] scores written
        return fused_adc_pool(qb, codes_t, cbt, masked_norms,
                              winners * -(-n // bucket))
    # masked_norms - 2 cross in one in-place pass (x -2 is exact, so this
    # rounds as the reference's two ops); + ||q||^2 is a per-row constant
    cross = _decode_cross(qb, codes_t, cbt)
    dist = torch.add(masked_norms, cross, alpha=-2.0, out=cross)
    n_pad = (-n) % bucket
    nb = (n + n_pad) // bucket
    if pool_mode == "approx":
        vals, idx = torch.topk(dist, min(winners * nb, n), dim=1,
                               largest=False, sorted=True)
        idx = idx.to(torch.int32)
        return vals, torch.where(torch.isfinite(vals), idx,
                                 torch.full_like(idx, -1))
    if n_pad:
        dist = torch.nn.functional.pad(dist, (0, n_pad), value=float("inf"))
    d3 = dist.view(q_n, bucket, nb)                             # strided sets
    col = torch.arange(nb, dtype=torch.int32, device=dist.device)
    pools, pvals = [], []
    for _ in range(winners):
        val, arg = torch.min(d3, dim=1)                         # [Q, nb]
        arg = arg.to(torch.int32)
        pools.append(torch.where(torch.isfinite(val), arg * nb + col,
                                 torch.full_like(arg, -1)))
        pvals.append(val)
        if winners > 1:
            d3 = d3.scatter(1, arg.long()[:, None, :], float("inf"))
    return torch.cat(pvals, dim=1), torch.cat(pools, dim=1)


def adc_fast_search(queries: torch.Tensor, codes_t: torch.Tensor,
                    cbt: torch.Tensor, valid: torch.Tensor,
                    base: Optional[torch.Tensor], ids: torch.Tensor, k: int,
                    bucket: int = 32, winners: int = 1, metric: str = "l2",
                    rerank_block: int = 512, chunk_n: int = 0,
                    pool_mode: str = "bucket",
                    code_norms: Optional[torch.Tensor] = None,
                    perm: Optional[torch.Tensor] = None,
                    packed_base: Optional[torch.Tensor] = None,
                    select_r: int = 0,
                    int8_base: Optional[torch.Tensor] = None,
                    int8_scales: Optional[torch.Tensor] = None,
                    int8_norms: Optional[torch.Tensor] = None,
                    int8_resid: Optional[torch.Tensor] = None,
                    int8_rscales: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fast codes-only pipeline: decode -> one product -> pool ->
    re-rank of the pool against the refine store.

    queries [Q, d] f32; codes_t [S, N] uint8; cbt [S*sd, K] f32; valid [N]
    bool; ids [N] external ids.  The refine reads ``int8_base`` (+ scales,
    exact norms, residual) when given, else the bf16 ``packed_base``
    (``ops/distance.pack_bf16_rows``), else the raw f32 ``base``.  With ``chunk_n`` in (0, N) the corpus is scored
    in chunks of ``chunk_n`` columns, so no [Q, N] block or [d, N]
    reconstruction exists; the last chunk is re-sliced to end at N and
    masks the slots earlier chunks covered (padding would copy the codes).
    ``select_r`` narrows a wider pool to its ``select_r`` best before the
    refine.  Returns (dists [Q, k], external ids [Q, k]) ascending.

    The scoring and pooling are the span ``index.scan``, the re-rank and id
    lookup ``index.refine``; ``utils/stats.GLOBAL`` counts the code columns
    the decode kernel reconstructed (``adc.decoded_rows``) and the pool
    slots re-ranked (``adc.refined``, Q x pool width), from shapes alone.
    """
    q_n = queries.shape[0]
    n = codes_t.shape[1]
    with span("index.scan"):
        # the scan runs in PQ space: normalized under cosine, then permuted
        q_scan = normalize_rows(queries) if metric == "cosine" else queries
        if perm is not None:
            q_scan = q_scan[:, perm]
        qb = q_scan.to(scan_dtype(queries.device)).contiguous()
        masked_norms = code_norms_from_codes(codes_t, cbt, valid, code_norms)

        if chunk_n <= 0 or chunk_n >= n:
            if pool_mode == "approx" and select_r > 0:
                # the ranked pool is already the top-select_r
                bucket = max(1, -(-n * winners // select_r))
            pool_vals, pool = _score_pool_chunk(
                qb, codes_t, cbt, masked_norms, bucket, winners, pool_mode)
            scored = n
        else:
            n_chunks = -(-n // chunk_n)
            if pool_mode == "approx" and select_r > 0:
                # per-chunk ranked pools of 4x the chunk's expected share of
                # the global top-select_r (floor 128), then one select below
                r_chunk = min(select_r,
                              max(128, -(-4 * select_r // n_chunks)))
                bucket = max(1, -(-chunk_n * winners // r_chunk))
            vals_l, pools_l = [], []
            for c in range(n_chunks):
                start = min(c * chunk_n, n - chunk_n)
                mn = masked_norms[start:start + chunk_n]
                if start < c * chunk_n:  # ragged last chunk: mask covered
                    mn = mn.clone()
                    mn[:c * chunk_n - start] = float("inf")
                lv, local = _score_pool_chunk(
                    qb, codes_t[:, start:start + chunk_n], cbt, mn, bucket,
                    winners, pool_mode)
                vals_l.append(lv)
                pools_l.append(torch.where(local >= 0, local + start, local))
            pool_vals = torch.cat(vals_l, dim=1)
            pool = torch.cat(pools_l, dim=1)
            scored = n_chunks * chunk_n
        pool = torch.where(pool < n, pool, torch.full_like(pool, -1))
        if 0 < select_r < pool.shape[1]:
            pv = torch.where(pool >= 0, pool_vals, float("inf"))
            _, sel = torch.topk(pv, select_r, dim=1, largest=False,
                                sorted=True)
            pool = torch.gather(pool, 1, sel)
    # code columns the decode kernel reconstructed: the norm pass, if any,
    # and every scored chunk (the fused kernel decodes in itself)
    decoded = (n if code_norms is None else 0) \
        + (scored if pool_mode != "fused" else 0)
    if decoded:
        GLOBAL.bump("adc.decoded_rows", decoded)
    GLOBAL.bump("adc.refined", q_n * pool.shape[1])

    with span("index.refine"):
        if int8_base is not None:
            out_d, slots = blocked_rerank_int8(
                queries, int8_base, int8_scales, pool, k, metric,
                rb=rerank_block, b_norms=int8_norms, resid=int8_resid,
                rscales=int8_rscales)
        else:
            out_d, slots = blocked_rerank(
                queries, base if packed_base is None else packed_base, pool,
                k, metric, rb=rerank_block)
        ext = torch.where(torch.isfinite(out_d),
                          ids[slots.clamp(min=0).long()],
                          torch.full_like(slots, -1).to(ids.dtype))
    return out_d, ext
