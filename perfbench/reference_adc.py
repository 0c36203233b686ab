"""The plain reference of the codes-only search: what ``adc_fast`` with a
ranked pool and a bf16 re-rank states it answers, in plain PyTorch, TF32
off, in float64.

It follows the configuration's semantics and not the program's route (the
program decodes the codes to a bf16 reconstruction and scores it with one
matrix product): the query is permuted by the index's ``perm``; its ADC
distance to a row is sum_s ||q_s - C_s[code_s]||^2, read from per-query
lookup tables [S, K] taken in float64; the pool is the ``select_r`` best
live rows by that distance; each pool row is rounded to bf16 and ranked by
its float64 squared L2 distance to the float32 query; the answer is the k
nearest, ascending, as euclidean distances.

It works from the trained state as plain tensors (codebooks [S, K, sd],
codes [N, S], perm [d] or None, the f32 rows [N, d], the live mask [N]),
which a test reads from the index, and imports nothing of the program.
Rows and queries go in blocks, so that it runs at 100,000 x 512 on the
card.
"""

from __future__ import annotations

import torch

from .reference import tf32_off

#: queries and rows a block holds
Q_BLOCK = 256
R_BLOCK = 1 << 14
#: queries whose [Q, R_BLOCK] float64 ADC distances one pool pass holds
POOL_Q_BLOCK = 2048


def adc_tables(queries: torch.Tensor, codebooks: torch.Tensor
               ) -> torch.Tensor:
    """[Q, S, K] float64: ||q_s - C_s[c]||^2 for each query (already in the
    codebooks' permuted space), subspace and centroid, as differences."""
    s, k, sd = codebooks.shape
    cb = codebooks.to(torch.float64)
    out = []
    for qa in range(0, queries.shape[0], Q_BLOCK):
        q = queries[qa:qa + Q_BLOCK].to(torch.float64).reshape(-1, s, 1, sd)
        out.append((q - cb[None]).square().sum(3))
    return torch.cat(out)


def adc_pool(tables: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor,
             select_r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(ADC distances [Q, r] float64 ascending, row slots [Q, r] int64) of
    the ``select_r`` live rows nearest by the tables, r = min(select_r,
    rows); +inf / -1 where fewer rows live."""
    q_n, s, _ = tables.shape
    n = codes.shape[0]
    r = min(select_r, n)
    codes = codes.long()
    best_d = torch.empty((q_n, 0), dtype=torch.float64, device=tables.device)
    best_i = torch.empty((q_n, 0), dtype=torch.int64, device=tables.device)
    for ra in range(0, n, R_BLOCK):
        blk = codes[ra:ra + R_BLOCK]
        d = torch.zeros((q_n, blk.shape[0]), dtype=torch.float64,
                        device=tables.device)
        for j in range(s):
            d += tables[:, j, :].index_select(1, blk[:, j])
        d.masked_fill_(~valid[None, ra:ra + blk.shape[0]], float("inf"))
        best_d = torch.cat([best_d, d], 1)
        best_i = torch.cat([best_i, torch.arange(
            ra, ra + blk.shape[0], device=tables.device).expand(q_n, -1)], 1)
        best_d, sel = torch.topk(best_d, min(r, best_d.shape[1]), dim=1,
                                 largest=False, sorted=True)
        best_i = torch.gather(best_i, 1, sel)
    return best_d, torch.where(torch.isfinite(best_d), best_i, -1)


def rerank_bf16(queries: torch.Tensor, rows: torch.Tensor,
                pool: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(row slots [Q, k] int64, euclidean distances [Q, k] float64) of the
    k pool rows (-1 ignored) nearest to each float32 query, each row
    rounded to bf16, ranked by float64 squared L2; ascending."""
    ids_out, d_out = [], []
    for qa in range(0, queries.shape[0], Q_BLOCK):
        q = queries[qa:qa + Q_BLOCK].to(torch.float64)
        p = pool[qa:qa + Q_BLOCK]
        v = rows[p.clamp(min=0)].to(torch.bfloat16).to(torch.float64)
        d2 = (v - q[:, None, :]).square().sum(2)
        d2 = torch.where(p >= 0, d2, float("inf"))
        d2, sel = torch.sort(d2, dim=1)
        ids_out.append(torch.gather(p, 1, sel[:, :k]))
        d_out.append(d2[:, :k].sqrt())
    return torch.cat(ids_out), torch.cat(d_out)


def search(queries: torch.Tensor, codebooks: torch.Tensor,
           codes: torch.Tensor, perm, rows: torch.Tensor,
           valid: torch.Tensor, k: int, select_r: int
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(row slots [Q, k], euclidean distances [Q, k] float64, the pool's
    row slots [Q, select_r]) of the codes-only search (see the module)."""
    with tf32_off():
        q = queries.to(torch.float32)
        qp = q if perm is None else q[:, torch.as_tensor(
            perm, device=q.device).long()]
        pool = torch.cat([
            adc_pool(adc_tables(qp[qa:qa + POOL_Q_BLOCK], codebooks), codes,
                     valid, select_r)[1]
            for qa in range(0, q.shape[0], POOL_Q_BLOCK)])
        ids, dists = rerank_bf16(q, rows, pool, k)
    return ids, dists, pool
