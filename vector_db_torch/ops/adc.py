"""Product-quantization encode (the training subset of
``vector_db_tpu/ops/adc.py``: ``pq_encode`` and ``balanced_subspace_perm``;
the ADC scans are ROADMAP A9/A10)."""

from __future__ import annotations

import numpy as np
import torch

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
