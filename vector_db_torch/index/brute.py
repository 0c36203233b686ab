"""Brute-force exact kNN index — the ground-truth oracle (the counterpart
of ``vector_db_tpu/index/brute.py``): a blocked distance matmul + exact
top-k over the raw store, 100% recall by construction."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.store import VectorStore
from ..ops.distance import blocked_knn
from .base import (VectorIndex, as_queries, pad_queries_pow2, pow2,
                   to_host_results)


class BruteForceIndex(VectorIndex):
    kind = "brute"

    def __init__(self, dim: int, capacity: int, metric: str = "l2",
                 block_n: int = 8192, device="cuda"):
        super().__init__(dim, capacity, metric)
        self.store = VectorStore(capacity, dim, device=device)
        self.device = self.store.device
        self.block_n = block_n

    # ------------------------------------------------------------- mutation
    def add_batch(self, ids: Sequence[int], vectors) -> list[int]:
        accepted, _ = self.store.add_batch(ids, vectors)
        return accepted

    def remove(self, vec_id: int) -> bool:
        return self.store.remove(vec_id) is not None

    def build(self) -> None:  # nothing to build: the store IS the index
        pass

    # --------------------------------------------------------------- search
    def search_batch(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = as_queries(queries, self.dim, self.device)
        st = self.store.state
        padded, q_n = pad_queries_pow2(q)
        k_eff = min(k, st.capacity)
        k_pad = min(pow2(k_eff), st.capacity)
        dists, slots = blocked_knn(
            padded, st.vectors, st.valid, k_pad, metric=self.metric,
            b_norms=st.norms, block_n=min(self.block_n, st.capacity),
        )
        return to_host_results(q_n, k, k_eff, slots, st.ids, dists)

    # ---------------------------------------------------------------- state
    def size(self) -> int:
        return self.store.size()

    def get(self, vec_id: int) -> Optional[np.ndarray]:
        return self.store.get(vec_id)

    # ------------------------------------------------------------ persistence
    def state_arrays(self) -> dict:
        return {"store": self.store.to_host()}

    def load_state_arrays(self, arrays: dict) -> None:
        self.store = VectorStore.from_host(arrays["store"], self.device)
