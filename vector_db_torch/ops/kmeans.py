"""k-means — the training primitive behind PQ (the counterpart of
``vector_db_tpu/ops/kmeans.py``).

Assignment is an argmin over a distance matmul and the update a one-hot
matmul, as in the reference.  The reference's ``vmap`` over PQ subspaces is
a leading batch dimension here: every function takes ``data`` [B, n, d]
(B independent problems, e.g. subspaces) and ``torch.bmm`` carries the
products.  Randomness comes from an explicit ``torch.Generator``; it does
not reproduce ``jax.random`` draws, so fits agree with the reference in
quality, not bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from .distance import pairwise_sq_l2


def _batched_sq_l2(data: torch.Tensor, centroids: torch.Tensor,
                   data_norms: torch.Tensor) -> torch.Tensor:
    """[B, n, d] x [B, k, d] -> [B, n, k] squared L2 (norm identity, the
    reference's pairwise_sq_l2 per batch), floored at 0."""
    c_norms = torch.sum(centroids * centroids, dim=-1)
    cross = torch.bmm(data, centroids.transpose(1, 2))
    d = data_norms[:, :, None] + c_norms[:, None, :]
    d.sub_(cross.mul_(2.0))
    return d.clamp_(min=0.0)


def _assign(data, centroids, data_norms) -> torch.Tensor:
    """Nearest-centroid assignment [B, n] int64."""
    return torch.argmin(_batched_sq_l2(data, centroids, data_norms), dim=-1)


def kmeans_plus_plus_init(gen: torch.Generator, data: torch.Tensor, k: int,
                          n_valid: Optional[int] = None) -> torch.Tensor:
    """k-means++ seeding: first centroid uniform, then each next one drawn
    with probability proportional to the squared distance to the nearest
    chosen centroid.  data [B, n, d] -> centroids [B, k, d]; rows at or
    past ``n_valid`` are never drawn."""
    b, n, d = data.shape
    n_valid = n if n_valid is None else int(n_valid)
    row_valid = (torch.arange(n, device=data.device) < n_valid).to(data.dtype)
    batch = torch.arange(b, device=data.device)
    first = torch.randint(0, max(n_valid, 1), (b,), generator=gen,
                          device=gen.device).to(data.device)
    centroids = torch.zeros((b, k, d), dtype=data.dtype, device=data.device)
    c = data[batch, first]                                  # [B, d]
    centroids[:, 0] = c
    min_d = torch.sum((data - c[:, None, :]) ** 2, dim=-1) * row_valid
    uniform = row_valid / max(n_valid, 1)
    for i in range(1, k):
        weights = min_d * row_valid
        total = torch.sum(weights, dim=1, keepdim=True)
        # all-zero weights (fewer distinct rows than k): sample uniformly
        probs = torch.where(total > 0, weights / total.clamp(min=1e-30),
                            uniform.expand(b, -1))
        choice = torch.multinomial(probs.to(gen.device), 1,
                                   generator=gen)[:, 0].to(data.device)
        c = data[batch, choice]
        centroids[:, i] = c
        d_new = torch.sum((data - c[:, None, :]) ** 2, dim=-1) * row_valid
        min_d = torch.minimum(min_d, d_new)
    return centroids


def lloyd_iteration(data: torch.Tensor, centroids: torch.Tensor,
                    data_norms: torch.Tensor, row_valid: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd step: assign + one-hot matmul update.  Empty clusters keep
    their previous centroid.  data [B, n, d], centroids [B, k, d],
    data_norms [B, n], row_valid [n] bool.  Returns (new_centroids,
    assignments [B, n])."""
    k = centroids.shape[1]
    assign = _assign(data, centroids, data_norms)
    onehot = torch.zeros(assign.shape + (k,), dtype=data.dtype,
                         device=data.device)
    onehot.scatter_(2, assign[:, :, None],
                    row_valid.to(data.dtype)[None, :, None].expand(
                        assign.shape[0], -1, 1))             # [B, n, k]
    counts = torch.sum(onehot, dim=1)                        # [B, k]
    sums = torch.bmm(onehot.transpose(1, 2), data)           # [B, k, d]
    new_c = torch.where(counts[:, :, None] > 0,
                        sums / counts.clamp(min=1)[:, :, None], centroids)
    return new_c, assign


def kmeans_fit(gen: torch.Generator, data: torch.Tensor, k: int,
               iters: int = 25, n_valid: Optional[int] = None,
               plus_plus: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeding + a fixed ``iters`` Lloyd steps (no early stop, like the
    reference).  data [B, n, d].  Returns (centroids [B, k, d],
    assignments [B, n])."""
    b, n, _ = data.shape
    n_valid = n if n_valid is None else int(n_valid)
    row_valid = torch.arange(n, device=data.device) < n_valid
    data = torch.where(row_valid[None, :, None], data, 0.0)
    data_norms = torch.sum(data * data, dim=-1)
    if plus_plus:
        centroids = kmeans_plus_plus_init(gen, data, k, n_valid)
    else:
        idx = torch.randint(0, max(n_valid, 1), (b, k), generator=gen,
                            device=gen.device).to(data.device)
        centroids = data[torch.arange(b, device=data.device)[:, None], idx]
    for _ in range(iters):
        centroids, _ = lloyd_iteration(data, centroids, data_norms, row_valid)
    return centroids, _assign(data, centroids, data_norms)


def subspace_kmeans_fit(gen: torch.Generator, data: torch.Tensor,
                        num_subspaces: int, k: int = 256, iters: int = 25,
                        n_valid: Optional[int] = None,
                        plus_plus: bool = True) -> torch.Tensor:
    """One codebook per PQ subspace, all subspaces as one batch.

    data [n, dim] with dim % num_subspaces == 0 -> codebooks
    [num_subspaces, k, dim / num_subspaces].
    """
    n, dim = data.shape
    if dim % num_subspaces != 0:
        raise ValueError(f"dim {dim} not divisible by {num_subspaces} subspaces")
    sub = data.reshape(n, num_subspaces, dim // num_subspaces).transpose(0, 1)
    codebooks, _ = kmeans_fit(gen, sub.contiguous(), k, iters, n_valid,
                              plus_plus)
    return codebooks


def kmeans_fit_blocked(gen: torch.Generator, data: torch.Tensor, k: int,
                       iters: int = 10, chunk: int = 8192) -> torch.Tensor:
    """Row-blocked Lloyd for large n * k (the ``scan_ivf`` coarse
    quantizer, whose nlist reaches thousands): each step streams the rows in
    ``chunk``-row blocks and accumulates (sums, counts), so the largest
    transient is one [chunk, k] score block, never the [n, k] one-hot of
    :func:`kmeans_fit`.  Random init from ``gen``, drawn as
    :func:`kmeans_fit` draws it for one problem (the same generator gives
    the same init).  data [n, d] with n % chunk == 0 (callers trim their
    sample, never pad it).  Returns the centroids [k, d] only."""
    n, d = data.shape
    if n % chunk:
        raise ValueError(f"rows ({n}) must be a multiple of chunk ({chunk})")
    idx = torch.randint(0, max(n, 1), (1, k), generator=gen,
                        device=gen.device).to(data.device)[0]
    centroids = data[idx]
    for _ in range(iters):
        sums = torch.zeros((k, d), dtype=data.dtype, device=data.device)
        counts = torch.zeros((k,), dtype=data.dtype, device=data.device)
        for s in range(0, n, chunk):
            blk = data[s:s + chunk]
            nearest = torch.argmin(pairwise_sq_l2(blk, centroids), dim=1)
            # a one-hot product, as in the reference: deterministic sums
            onehot = torch.nn.functional.one_hot(nearest, k).to(data.dtype)
            sums += onehot.T @ blk
            counts += onehot.sum(0)
        centroids = torch.where(counts[:, None] > 0,
                                sums / counts.clamp(min=1)[:, None], centroids)
    return centroids
