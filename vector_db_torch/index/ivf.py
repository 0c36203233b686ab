"""IVF (inverted-file) index: a coarse k-means quantizer and an nprobe
cluster scan (the counterpart of ``vector_db_tpu/index/ivf.py``).

Cluster membership is a quota-capped ``[nlist, L]`` slot table plus a shared
overflow list (``core/member_table.py``, host numpy, rebuilt after
mutations).  A search scores the queries against the centroids, gathers the
probed clusters' members and the overflow list, drops duplicates and dead
slots, re-ranks the candidates exactly in column blocks, and fills rows the
probed clusters could not fill with fixed-seed random live slots at their
exact distances.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.config import IvfConfig
from ..core.derived import DerivedCache
from ..core.member_table import build_member_table
from ..core.store import VectorStore
from ..ops.distance import (blocked_knn, blocked_rerank, pairwise_dist,
                            rerank_columns)
from ..ops.kmeans import kmeans_fit
from ..ops.topk import smallest_k
from .base import (VectorIndex, as_queries, pad_queries_pow2, pow2,
                   to_host_results)

#: elements of the [rows, nlist] distance block one assignment step holds
ASSIGN_BLOCK_ELEMS = 1 << 26


def ivf_candidates(queries: torch.Tensor, centroids: torch.Tensor,
                   members: torch.Tensor, overflow: torch.Tensor,
                   valid: torch.Tensor, nprobe: int, metric: str
                   ) -> torch.Tensor:
    """Candidate slots [Q, nprobe * L + |overflow|] of a batch: the members
    of each query's ``nprobe`` nearest clusters and the overflow list
    (always scanned, so the quota loses nothing), sorted, with duplicates
    (multi-assigned rows) and dead slots set to -1."""
    q_n = queries.shape[0]
    cd = pairwise_dist(queries, centroids, metric)               # [Q, C]
    probes = torch.topk(cd, nprobe, dim=1, largest=False, sorted=True)[1]
    cand = torch.cat([members[probes].reshape(q_n, -1),
                      overflow[None, :].expand(q_n, -1)], dim=1)
    cand = torch.sort(cand, dim=1)[0]
    dup = torch.zeros_like(cand, dtype=torch.bool)
    dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
    cand = cand.masked_fill_(dup, -1)
    return torch.where(valid[cand.clamp(min=0).long()], cand,
                       torch.full_like(cand, -1))


def ivf_search(queries: torch.Tensor, centroids: torch.Tensor,
               members: torch.Tensor, overflow: torch.Tensor,
               base: torch.Tensor, valid: torch.Tensor,
               fill_slots: torch.Tensor, nprobe: int, k: int, metric: str
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One batch's IVF search (the reference's ``_ivf_search``): the
    candidates of :func:`ivf_candidates` re-ranked by ``blocked_rerank``
    (blocks of at least the reference's 512 columns, wider for a small
    batch: ``ops/distance.rerank_columns``), then merged with the fill
    slots [F] (-1 padded) at their exact distances, which never displace a
    real hit.  Returns (dists [Q, k], slots [Q, k]) ascending; +inf / -1
    where empty."""
    cand = ivf_candidates(queries, centroids, members, overflow, valid,
                          nprobe, metric)
    top_d, top_i = blocked_rerank(
        queries, base, cand, k, metric,
        rb=rerank_columns(queries.shape[0], base.shape[1], 512))
    safe = fill_slots.clamp(min=0).long()
    f_ok = (fill_slots >= 0) & valid[safe]
    fd = pairwise_dist(queries, base[safe], metric)              # [Q, F]
    already = torch.any(fill_slots[None, None, :] == top_i[:, :, None], dim=1)
    fd = fd.masked_fill_(~(f_ok[None, :] & ~already), float("inf"))
    cat_d = torch.cat([top_d, fd], dim=1)
    cat_i = torch.cat([top_i, fill_slots[None, :].expand(fd.shape[0], -1)
                       .to(top_i.dtype)], dim=1)
    return smallest_k(cat_d, k, cat_i)


class IvfIndex(VectorIndex):
    kind = "ivf"

    def __init__(self, dim: int, capacity: int, metric: str = "l2",
                 config: Optional[IvfConfig] = None, device="cuda"):
        super().__init__(dim, capacity, metric)
        self.config = config or IvfConfig()
        self.store = VectorStore(capacity, dim, device=device)
        self.device = self.store.device
        self.centroids: Optional[torch.Tensor] = None  # [C, d]
        # slot -> its top-a clusters (column 0 the primary assignment)
        self.assignments = np.full(
            (self.store.capacity, max(1, self.config.multi_assign)), -1,
            np.int32)
        # the member table, voided by every mutation that moves it
        self._member_cache = DerivedCache()
        self.trained = False
        self.seed = 42
        self._removals_since_train = 0

    # ------------------------------------------------------------- mutation
    def add_batch(self, ids: Sequence[int], vectors) -> list[int]:
        accepted, slots = self.store.add_batch(ids, vectors)
        if accepted and self.trained:
            self._assign_slots(np.asarray(slots, np.int64))
        return accepted

    def remove(self, vec_id: int) -> bool:
        slot = self.store.remove(vec_id)
        if slot is None:
            return False
        self.assignments[slot, :] = -1
        self._member_cache.void()
        # the centroids drift from the live rows: retrain past a quarter
        self._removals_since_train += 1
        if self.trained and \
                self._removals_since_train > max(64, self.store.size() // 4):
            self.build()
        return True

    # --------------------------------------------------------------- build
    def build(self) -> None:
        """Train the coarse quantizer (k-means++ and the configured Lloyd
        steps, at most N // 10 clusters) and assign every live row."""
        n = self.store.size()
        n_clusters = max(1, min(self.config.num_clusters, max(n // 10, 1)))
        if n < 2:
            return
        live = np.flatnonzero(self.store.state.valid.cpu().numpy())
        data = self.store.state.vectors[torch.as_tensor(live,
                                                        device=self.device)]
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        centroids, _ = kmeans_fit(gen, data[None], k=n_clusters,
                                  iters=self.config.training_iterations,
                                  plus_plus=True)
        self.centroids = centroids[0]
        self.assignments[:] = -1
        self._assign_slots(live)
        self.trained = True
        self._member_cache.void()
        self._removals_since_train = 0

    def _assign_slots(self, slots: np.ndarray) -> None:
        """Each slot's top-a clusters (multi-assignment spilling)."""
        c = int(self.centroids.shape[0])
        a = min(max(1, self.config.multi_assign), c)
        rows = max(1, ASSIGN_BLOCK_ELEMS // c)
        self.assignments[slots] = -1
        for s in range(0, slots.size, rows):
            blk = slots[s:s + rows]
            sl = torch.as_tensor(blk, device=self.device)
            d = pairwise_dist(self.store.state.vectors[sl], self.centroids,
                              self.metric)
            top_a = torch.topk(d, a, dim=1, largest=False, sorted=True)[1]
            self.assignments[blk, :a] = top_a.cpu().numpy()
        self._member_cache.void()

    def _member_table(self) -> tuple[torch.Tensor, int, torch.Tensor]:
        """The quota-capped [C, L] member table (quota 8x the mean cluster),
        L and the overflow list, rebuilt after mutations."""
        return self._member_cache.get(True, self._build_member_table)

    def _build_member_table(self) -> tuple[torch.Tensor, int, torch.Tensor]:
        table, max_len, over = build_member_table(
            self.assignments, self.store.state.valid.cpu().numpy(),
            int(self.centroids.shape[0]), quota_mult=8.0, align=8)
        return (torch.as_tensor(table, device=self.device), max_len,
                torch.as_tensor(over, device=self.device))

    def fill_slots(self, k_pad: int) -> np.ndarray:
        """The fixed-seed random fill pool [k_pad] (-1 padded): live slots
        drawn as the reference draws them, so both packages fill alike."""
        live = np.flatnonzero(self.store.state.valid.cpu().numpy())
        rng = np.random.default_rng(self.seed + live.size)
        f = min(k_pad, live.size)
        fill = rng.choice(live, f, replace=False).astype(np.int32)
        if f < k_pad:
            fill = np.concatenate([fill, np.full(k_pad - f, -1, np.int32)])
        return fill

    # --------------------------------------------------------------- search
    def search_batch(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = as_queries(queries, self.dim, self.device)
        st = self.store.state
        padded, q_n = pad_queries_pow2(q)
        k_eff = min(k, st.capacity)
        k_pad = min(pow2(k_eff), st.capacity)
        if not self.trained or self.store.size() <= k:
            dists, slots = blocked_knn(
                padded, st.vectors, st.valid, k_pad, metric=self.metric,
                b_norms=st.norms, block_n=min(8192, st.capacity))
        else:
            members, _, overflow = self._member_table()
            nprobe = min(self.config.num_probes, int(self.centroids.shape[0]))
            fill = torch.as_tensor(self.fill_slots(k_pad), device=self.device)
            dists, slots = ivf_search(padded, self.centroids, members,
                                      overflow, st.vectors, st.valid, fill,
                                      nprobe, k_pad, self.metric)
        return to_host_results(q_n, k, k_eff, slots, st.ids, dists)

    # ---------------------------------------------------------------- state
    def size(self) -> int:
        return self.store.size()

    def get(self, vec_id: int) -> Optional[np.ndarray]:
        return self.store.get(vec_id)

    def stats(self) -> dict:
        s = super().stats()
        s.update(
            trained=self.trained,
            num_clusters=int(self.centroids.shape[0]) if self.trained else 0,
            num_probes=self.config.num_probes,
            multi_assign=self.config.multi_assign,
        )
        return s

    # ------------------------------------------------------------ persistence
    def state_arrays(self) -> dict:
        out = {"store": self.store.to_host(),
               "assignments": self.assignments,
               "trained": np.asarray([self.trained])}
        if self.centroids is not None:
            out["centroids"] = self.centroids.cpu().numpy()
        return out

    def load_state_arrays(self, arrays: dict) -> None:
        self.store = VectorStore.from_host(arrays["store"], self.device)
        assign = np.asarray(arrays["assignments"], np.int32).copy()
        if assign.ndim == 1:  # the single-assignment checkpoint format
            assign = assign[:, None]
        self.assignments = assign
        self.trained = bool(np.asarray(arrays["trained"])[0])
        self.centroids = (torch.tensor(np.asarray(arrays["centroids"],
                                                  np.float32),
                                       device=self.device)
                          if "centroids" in arrays else None)
        self._member_cache.void()
