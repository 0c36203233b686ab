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

from ..ops.distance import blocked_knn
from ..utils.stats import span


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


class DeferInsertMixin:
    """The deferred-insert policy of the graph indexes (HnswIndex,
    HnswPqIndex; a copy of the reference's mixin): pending adds are buffered
    in a slot mask, searches overlay the pending rows exactly, and a
    threshold flush connects the whole batch with exact-kNN delta insertion
    (``ops/hnsw_graph.bulk_insert_delta``).

    The host state lives here; subclasses provide ``store``, ``graph``,
    ``device``, ``config`` (m / flush_min / flush_frac / flush_max /
    flush_chunk), ``_sample_levels``, the from-scratch ``_graph_insert``
    hook, and ``_graph_heuristic``.
    """

    _graph_heuristic: bool = True

    def _graph_insert(self, slots: np.ndarray) -> None:
        raise NotImplementedError

    def _init_pending(self, capacity: int) -> None:
        self._pending_mask = np.zeros(capacity, bool)
        self._pending_count = 0
        self._pending_pad_cache = None

    def _pend_slots(self, slots_np: np.ndarray) -> None:
        """Buffer new slots; flush once the batch amortizes.  With
        ``config.flush_chunk > 0`` a threshold flush connects at most that
        many slots; the rest stay visible through the overlay and drain on
        later adds (or an explicit :meth:`flush_pending`)."""
        self._pending_mask[slots_np] = True
        self._pending_count += len(slots_np)
        self._pending_pad_cache = None
        if self._pending_count >= self._flush_threshold():
            chunk = int(getattr(self.config, "flush_chunk", 0))
            self.flush_pending(limit=chunk if chunk > 0 else None)

    def _unpend_slot(self, slot: int) -> bool:
        """Drop a removed slot that never reached the graph; True if it
        was pending."""
        if self._pending_mask[slot]:
            self._pending_mask[slot] = False
            self._pending_count -= 1
            self._pending_pad_cache = None
            return True
        return False

    def _clear_pending(self) -> None:
        self._pending_mask[:] = False
        self._pending_count = 0
        self._pending_pad_cache = None

    def _flush_threshold(self) -> int:
        """Pending count that triggers a flush: a fraction of the connected
        graph (the delta insert amortises against it), floored so tiny
        indexes never flush per add and capped so the overlay scan of a
        search stays bounded."""
        graph_live = max(0, self.store.size() - self._pending_count)
        return max(self.config.flush_min,
                   min(int(self.config.flush_frac * graph_live),
                       self.config.flush_max))

    def flush_pending(self, limit: Optional[int] = None) -> None:
        """Connect pending slots to the graph (exact-kNN delta insert; the
        from-scratch path while the graph is empty).  ``limit`` caps how
        many slots this call connects (lowest slot first); the rest stay
        pending and searchable through the overlay."""
        if self._pending_count == 0:
            return
        slots = np.flatnonzero(self._pending_mask).astype(np.int32)
        if limit is not None and 0 < limit < slots.size:
            slots = slots[:limit]
            self._pending_mask[slots] = False
            self._pending_count -= int(slots.size)
            self._pending_pad_cache = None
        else:
            self._clear_pending()
        if slots.size == 0:
            return
        if self.graph.entry < 0:
            self._graph_insert(slots)
            return
        from ..ops import hnsw_graph as hg

        st = self.store.state
        hg.bulk_insert_delta(
            self.graph, st.vectors, st.norms, st.valid, slots,
            self._sample_levels(len(slots)), m=self.config.m,
            heuristic=self._graph_heuristic)

    def _pending_padded(self) -> torch.Tensor:
        """Pending slots padded with -1 to a power of two (at least 8), as
        a device tensor cached until the pending set changes."""
        if self._pending_pad_cache is None:
            slots = np.flatnonzero(self._pending_mask).astype(np.int32)
            n_pad = max(8, pow2(slots.size))
            self._pending_pad_cache = torch.as_tensor(np.concatenate(
                [slots, np.full(n_pad - slots.size, -1, np.int32)]),
                device=self.device)
        return self._pending_pad_cache


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


def backfill_short_rows(index, padded: torch.Tensor, q_n: int, k_eff: int,
                        k_pad: int, dists: torch.Tensor, slots: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Result rows a candidate index (LSH, Annoy) left short, -1 among the
    first ``k_eff`` slots of a real query: counted in the index's
    ``_backfill_rows`` / ``_backfill_queries``, and filled from the exact
    scan unless ``index.config.backfill`` is False.  Returns (dists,
    slots)."""
    miss = (slots[:q_n, :k_eff] < 0).cpu().numpy()
    if not miss.any():
        return dists, slots
    index._backfill_rows += int(miss.sum())
    index._backfill_queries += int(miss.any(axis=1).sum())
    if not index.config.backfill:
        return dists, slots
    st = index.store.state
    fd, fs = blocked_knn(padded, st.vectors, st.valid, k_pad,
                         metric=index.metric, b_norms=st.norms,
                         block_n=min(8192, st.capacity))
    miss_all = slots < 0
    return torch.where(miss_all, fd, dists), torch.where(miss_all, fs, slots)


def host_results(q_n: int, k: int, k_eff: int, ids: np.ndarray,
                 dists: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host [q_n, k] result arrays from host [>= q_n, >= k_eff] ids and
    distances: their first ``k_eff`` columns, then -1 / +inf."""
    out_ids = np.full((q_n, k), -1, np.int32)
    out_d = np.full((q_n, k), np.inf, np.float32)
    out_ids[:, :k_eff] = ids[:q_n, :k_eff]
    out_d[:, :k_eff] = dists[:q_n, :k_eff]
    return out_ids, out_d


def slot_ids(slots: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The external ids of store slots (the store's ``ids`` tensor), -1
    where a slot is -1."""
    return torch.where(slots >= 0, ids[slots.clamp(min=0).long()],
                       torch.full_like(slots, -1))


def to_host_results(q_n: int, k: int, k_eff: int, ids: torch.Tensor,
                    slots_to_ids: Optional[torch.Tensor],
                    dists: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """Shape a device result into host [q_n, k] arrays.  With
    ``slots_to_ids`` (the store's ids tensor) ``ids`` holds slots and is
    mapped to external ids on the device first; either way one transfer
    per array brings back only the [Q, k] result (the span
    ``index.fetch``, which holds the wait for the answers)."""
    with span("index.fetch"):
        if slots_to_ids is not None:
            ids = slot_ids(ids, slots_to_ids)
        return host_results(q_n, k, k_eff,
                            ids[:q_n, :k_eff].cpu().numpy(),
                            dists[:q_n, :k_eff].cpu().numpy())
