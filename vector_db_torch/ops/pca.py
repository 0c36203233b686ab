"""PCA-proxy filtering: a truncated-PCA first stage for k-NN search (the
counterpart of ``vector_db_tpu/ops/pca.py``).

A [p << d]-dimensional PCA projection of the corpus (the proxy, bf16
[N, p]: 128 B a row at p=64) is scanned with one small product, the ranked
top-R by proxy distance is kept, and only those R rows are re-ranked against
the refine store.  Scoring needs no decode pass, so the stage costs p/d of an
exact scan.  Truncated PCA needs a decaying eigenspectrum (real embeddings
have one; isotropic noise does not).

Past 6 GB of [Q, N] f32 proxy distances the scan goes chunk by chunk with a
ranked pool a chunk and one final select, so [Q, N] never exists.  The proxy
product takes bf16 inputs and accumulates in f32, and every selection is an
exact ``torch.topk`` on the f32 distances (the reference rounds them to bf16
and selects with ``approx_max_k``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .distance import (_bf16_mm, blocked_rerank, blocked_rerank_int8,
                       normalize_rows)

#: largest [Q, N] f32 proxy-distance matrix scored in one pass
FULL_ROW_BYTES = 6 * 1024 ** 3
#: proxy rows whose f32 copy one step of rows_sq_norms holds
NORM_CHUNK_ROWS = 1 << 20


def pca_fit(sample: np.ndarray, p: int) -> tuple[np.ndarray, np.ndarray]:
    """Fit a truncated-PCA basis on a host sample (numpy float64 ``eigh``,
    the reference's own code, so both packages get the same basis from the
    same sample): sample [m, d] -> (mean [d], basis [d, p]) f32, the
    eigenvectors of the sample covariance for the p largest eigenvalues."""
    sample = np.asarray(sample, np.float64)
    mu = sample.mean(axis=0)
    cov = np.cov((sample - mu).T)
    w, v = np.linalg.eigh(cov)
    order = np.argsort(-w)[:p]
    return mu.astype(np.float32), v[:, order].astype(np.float32)


def project_rows(vectors: torch.Tensor, mean: torch.Tensor,
                 basis: torch.Tensor) -> torch.Tensor:
    """[N, d] rows -> centered projections [N, p] bf16 (the proxy store)."""
    return ((vectors - mean[None, :]) @ basis).to(torch.bfloat16)


def rows_sq_norms(rows: torch.Tensor) -> torch.Tensor:
    """Squared norms [N] f32 of bf16 rows, ``NORM_CHUNK_ROWS`` rows a step:
    the f32 copy of the whole proxy (2.5 GB at 10M x 64) never exists."""
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=rows.device)
    for s in range(0, rows.shape[0], NORM_CHUNK_ROWS):
        r32 = rows[s:s + NORM_CHUNK_ROWS].to(torch.float32)
        out[s:s + NORM_CHUNK_ROWS] = torch.sum(r32 * r32, dim=1)
    return out


def _chunk_pool(qp: torch.Tensor, pt_blk: torch.Tensor, mn_blk: torch.Tensor,
                rk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ranked top-``rk`` of one proxy block: (values [Q, rk], local
    rows [Q, rk] int32, -1 where empty).  ``mn_blk`` holds the squared
    proxy norms with +inf at rows to skip; ``+ ||q_p||^2`` is a per-row
    constant and is left out."""
    cross = _bf16_mm(qp, pt_blk)
    dist = torch.add(mn_blk[None, :], cross, alpha=-2.0, out=cross)
    vals, sel = torch.topk(dist, min(rk, pt_blk.shape[0]), dim=1,
                           largest=False, sorted=True)
    sel = sel.to(torch.int32)
    return vals, torch.where(torch.isfinite(vals), sel,
                             torch.full_like(sel, -1))


def pca_proxy_search(queries: torch.Tensor, mean: torch.Tensor,
                     basis: torch.Tensor, proxy: torch.Tensor,
                     proxy_norms: torch.Tensor, valid: torch.Tensor,
                     base: Optional[torch.Tensor], ids: torch.Tensor, k: int,
                     select_r: int = 256, metric: str = "l2",
                     rerank_block: int = 512,
                     packed_base: Optional[torch.Tensor] = None,
                     block_n: int = 131072, force_chunked: bool = False,
                     int8_base: Optional[torch.Tensor] = None,
                     int8_scales: Optional[torch.Tensor] = None,
                     int8_norms: Optional[torch.Tensor] = None,
                     int8_resid: Optional[torch.Tensor] = None,
                     int8_rscales: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Proxy scan, ranked top-R, blocked refine.

    queries [Q, d] f32; proxy [N, p] bf16 (:func:`project_rows`);
    proxy_norms [N] f32 (:func:`rows_sq_norms`, unmasked); valid [N]; ids
    [N] external ids.  The refine reads ``int8_base`` (+ scales, exact
    norms, residual) when given, else the bf16 ``packed_base``, else the raw
    f32 ``base``.  Returns (dists [Q, k], external ids [Q, k]) ascending.

    The proxy ranking is squared L2 in PCA space.  Under ``metric="cosine"``
    the proxy must hold projections of row-normalized vectors (the index
    sees to that) and the query is normalized before projection: L2 on the
    unit sphere ranks as cosine does, raw projections of rows of varied
    norm do not.  The refine uses the raw queries either way (cosine
    distance does not depend on the query's scale).

    One full-row pass while the [Q, N] f32 distances fit ``FULL_ROW_BYTES``;
    else (or with ``force_chunked``) chunks of ``block_n`` rows, each
    keeping a ranked pool of 4x its expected share of the final top-R
    (floor 128), then one select over the pools.  The last chunk is
    re-sliced to end at N and masks the rows earlier chunks covered:
    padding would copy the whole proxy.
    """
    q_scan = normalize_rows(queries) if metric == "cosine" else queries
    qp = ((q_scan - mean[None, :]) @ basis).to(proxy.dtype)       # [Q, p]
    q_n, n = queries.shape[0], proxy.shape[0]
    r = min(select_r, n)
    masked = torch.where(valid, proxy_norms, float("inf"))

    if q_n * n * 4 <= FULL_ROW_BYTES and not force_chunked:
        _, pool = _chunk_pool(qp, proxy, masked, r)
    else:
        block_n = min(block_n, n)
        num_chunks = -(-n // block_n)
        r_chunk = min(r, max(128, -(-4 * r // max(num_chunks, 1))))
        vals_l, pools_l = [], []
        for c in range(num_chunks):
            start = min(c * block_n, n - block_n)
            mn = masked[start:start + block_n]
            if start < c * block_n:  # ragged last chunk: mask covered rows
                mn = mn.clone()
                mn[:c * block_n - start] = float("inf")
            pv, loc = _chunk_pool(qp, proxy[start:start + block_n], mn,
                                  r_chunk)
            vals_l.append(pv)
            pools_l.append(torch.where(loc >= 0, loc + start, loc))
        cand = torch.cat(pools_l, dim=1)
        cvals = torch.cat(vals_l, dim=1)
        cvals = torch.where(cand >= 0, cvals, float("inf"))
        _, sel = torch.topk(cvals, min(r, cand.shape[1]), dim=1,
                            largest=False, sorted=True)
        pool = torch.gather(cand, 1, sel)

    if int8_base is not None:
        out_d, slots = blocked_rerank_int8(
            queries, int8_base, int8_scales, pool, k, metric,
            rb=rerank_block, b_norms=int8_norms, resid=int8_resid,
            rscales=int8_rscales)
    else:
        out_d, slots = blocked_rerank(
            queries, base if packed_base is None else packed_base, pool, k,
            metric, rb=rerank_block)
    ext = torch.where(torch.isfinite(out_d), ids[slots.clamp(min=0).long()],
                      torch.full_like(slots, -1).to(ids.dtype))
    return out_d, ext
