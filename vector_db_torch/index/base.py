"""Abstract index interface — the ``VectorIndex`` seam every index
implements (the counterpart of ``vector_db_tpu/index/base.py``).

Batch-first: ``search_batch`` takes a [Q, dim] query matrix (numpy array or
tensor) and returns host numpy arrays (ids [Q, k] int32, -1 padded; dists
[Q, k] float32).
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def pow2(n: int) -> int:
    """Next power of two (>=1)."""
    return 1 << (max(int(n), 1) - 1).bit_length()


def pad_queries_pow2(queries: torch.Tensor, min_q: int = 8
                     ) -> tuple[torch.Tensor, int]:
    """Pad a [Q, d] query batch with zero rows to the next power of two
    (at least ``min_q``), as the reference does: a bounded set of batch
    shapes.  Returns (padded queries, original Q)."""
    q_n = queries.shape[0]
    qp = pow2(max(q_n, min_q))
    if qp != q_n:
        queries = torch.nn.functional.pad(queries, (0, 0, 0, qp - q_n))
    return queries, q_n


class VectorIndex(abc.ABC):
    """Batch-first ANN index over a device-resident corpus."""

    #: human-readable type tag, e.g. "brute", "hnswpq"
    kind: str = "base"

    def __init__(self, dim: int, capacity: int, metric: str = "l2"):
        self.dim = dim
        self.capacity = capacity
        self.metric = metric

    # ------------------------------------------------------------- mutation
    @abc.abstractmethod
    def add_batch(self, ids: Sequence[int], vectors) -> list[int]:
        """Insert vectors; returns the list of accepted external ids."""

    def add(self, vec_id: int, vector) -> bool:
        """Insert one vector."""
        vec = torch.as_tensor(vector, dtype=torch.float32)
        return bool(self.add_batch([vec_id], vec[None, :]))

    @abc.abstractmethod
    def remove(self, vec_id: int) -> bool:
        """Remove by external id (tombstone)."""

    @abc.abstractmethod
    def build(self) -> None:
        """(Re)build internal structures from live vectors."""

    # --------------------------------------------------------------- search
    @abc.abstractmethod
    def search_batch(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """k-NN for a [Q, dim] query batch.

        Returns (ids [Q, k] int32 external ids with -1 padding,
                 dists [Q, k] float32 squared-L2 / cosine distances).
        """

    def search(self, query, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = torch.as_tensor(query, dtype=torch.float32)
        ids, dists = self.search_batch(q[None, :], k)
        return ids[0], dists[0]

    # ---------------------------------------------------------------- state
    @abc.abstractmethod
    def size(self) -> int:
        """Number of live vectors."""

    @abc.abstractmethod
    def get(self, vec_id: int) -> Optional[np.ndarray]:
        """Fetch a stored vector by external id."""

    # ------------------------------------------------------------ persistence
    def state_arrays(self) -> dict:
        """Checkpointable host arrays."""
        return {}

    def load_state_arrays(self, arrays: dict) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------- metadata
    def stats(self) -> dict:
        return {
            "kind": self.kind,
            "size": self.size(),
            "dim": self.dim,
            "capacity": self.capacity,
            "metric": self.metric,
        }


def as_queries(queries, dim: int, device: torch.device) -> torch.Tensor:
    """Queries as a [Q, dim] float32 tensor on ``device``; raises on a
    wrong shape."""
    q = torch.as_tensor(queries, dtype=torch.float32).to(device)
    if q.ndim != 2 or q.shape[1] != dim:
        raise ValueError(f"expected [*, {dim}] queries, got {tuple(q.shape)}")
    return q


def to_host_results(q_n: int, k: int, k_eff: int, ids: torch.Tensor,
                    slots_to_ids: Optional[torch.Tensor],
                    dists: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """Shape a device result into host [q_n, k] arrays.  With
    ``slots_to_ids`` (the store's ids tensor) ``ids`` holds slots and is
    mapped to external ids on the device first; either way one transfer
    per array brings back only the [Q, k] result."""
    if slots_to_ids is not None:
        ids = torch.where(ids >= 0, slots_to_ids[ids.clamp(min=0).long()],
                          torch.full_like(ids, -1))
    out_ids = np.full((q_n, k), -1, np.int32)
    out_d = np.full((q_n, k), np.inf, np.float32)
    out_ids[:, :k_eff] = ids[:q_n, :k_eff].cpu().numpy()
    out_d[:, :k_eff] = dists[:q_n, :k_eff].cpu().numpy()
    return out_ids, out_d
