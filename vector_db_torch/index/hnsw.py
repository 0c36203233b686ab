"""HNSW index: hierarchical navigable small-world graph over the raw f32
store (the counterpart of ``vector_db_tpu/index/hnsw.py``).

The graph lives in ``ops/hnsw_graph.py`` as padded adjacency tensors.  A
from-scratch build is exact-kNN construction (``bulk_build``); adds are
deferred (buffered, answered through an exact overlay, connected in bulk by
``bulk_insert_delta``) or, with ``insert_policy="stream"``, inserted in
batched rounds the moment they arrive.  Under ``metric="cosine"`` vectors
are L2-normalized at the boundary, so squared-L2 traversal orders as cosine
distance does, and results are halved back to 1 - cos.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.config import HnswConfig
from ..core.store import VectorStore
from ..ops import hnsw_graph as hg
from ..ops.distance import blocked_knn, normalize_rows
from .base import (DeferInsertMixin, VectorIndex, as_queries,
                   pad_queries_pow2, pow2, to_host_results)


def graph_to_host(graph: hg.HnswGraph) -> dict:
    """The graph under the reference's checkpoint keys."""
    return {"neighbors": graph.neighbors.cpu().numpy(),
            "levels": graph.levels.cpu().numpy(),
            "entry": np.asarray(graph.entry, np.int32),
            "entry_level": np.asarray(graph.entry_level, np.int32)}


def graph_from_host(g: dict, device) -> hg.HnswGraph:
    """Inverse of :func:`graph_to_host` (either package's arrays)."""
    return hg.HnswGraph(
        torch.tensor(np.asarray(g["neighbors"], np.int32), device=device),
        torch.tensor(np.asarray(g["levels"], np.int32), device=device),
        int(np.asarray(g["entry"])), int(np.asarray(g["entry_level"])))


def sample_graph_levels(seed: int, counter: int, n: int, m: int,
                        max_level: int) -> np.ndarray:
    """Geometric levels, mL = 1 / ln(M), from a numpy generator seeded
    ``seed * 1_000_003 + counter`` (the reference's stream: both packages
    draw the same levels for the same sequence of insertions)."""
    rng = np.random.default_rng(seed * 1_000_003 + counter)
    u = rng.uniform(1e-12, 1.0, n)
    ml = 1.0 / np.log(max(m, 2))
    return np.clip(np.floor(-np.log(u) * ml).astype(np.int32), 0,
                   max_level - 1)


def fix_entry_after_unlink(graph: hg.HnswGraph, valid: torch.Tensor) -> None:
    """After the entry point was unlinked: the live node of the highest
    level becomes the entry point (-1 when none is left)."""
    levels = graph.levels.cpu().numpy()
    live = np.flatnonzero(valid.cpu().numpy() & (levels >= 0))
    if live.size:
        graph.entry = int(live[np.argmax(levels[live])])
        graph.entry_level = int(levels[graph.entry])
    else:
        graph.entry = graph.entry_level = -1


class HnswIndex(DeferInsertMixin, VectorIndex):
    kind = "hnsw"

    def __init__(self, dim: int, capacity: int, metric: str = "l2",
                 config: Optional[HnswConfig] = None, device="cuda"):
        super().__init__(dim, capacity, metric)
        # private copy: optimize_for_high_dimension adjusts it
        self.config = dataclasses.replace(config) if config else HnswConfig()
        self.store = VectorStore(capacity, dim, device=device)
        self.device = self.store.device
        self._max_level = self.config.derived_max_level(self.store.capacity)
        self.graph = hg.init_graph(self.store.capacity, self.config.m,
                                   self._max_level, self.device)
        self.seed = 42
        self._level_counter = 0  # a distinct level stream per insertion
        self._init_pending(self.store.capacity)

    # ------------------------------------------------------------- helpers
    def _prep(self, vectors) -> torch.Tensor:
        vectors = torch.as_tensor(vectors, dtype=torch.float32)
        if self.metric == "cosine":
            # L2 on unit vectors == 2 (1 - cos)
            vectors = normalize_rows(vectors)
        return vectors

    def _sample_levels(self, n: int) -> np.ndarray:
        self._level_counter += 1
        return sample_graph_levels(self.seed, self._level_counter - 1, n,
                                   self.config.m, self._max_level)

    # ------------------------------------------------------------- mutation
    def add_batch(self, ids: Sequence[int], vectors) -> list[int]:
        accepted, slots = self.store.add_batch(ids, self._prep(vectors))
        if not accepted:
            return []
        slots_np = np.asarray(slots, np.int32)
        if self.config.insert_policy == "defer":
            self._pend_slots(slots_np)
        else:
            self._graph_insert(slots_np)
        return accepted

    @property
    def _graph_heuristic(self) -> bool:
        return self.config.heuristic

    def _graph_insert(self, slots: np.ndarray) -> None:
        """Insert store slots into the graph: the exact-kNN bulk build into
        an empty graph (``bulk_build`` and at least 4 m slots), else batched
        insertion rounds.  (Also the mixin's hook for a flush into an empty
        graph.)"""
        levels = self._sample_levels(len(slots))
        st = self.store.state
        live = self.store.size() - len(slots)  # graph size before this call
        cfg = self.config
        if cfg.bulk_build and self.graph.entry < 0 and len(slots) >= 4 * cfg.m:
            hg.bulk_build(self.graph, st.vectors, st.norms, slots, levels,
                          m=cfg.m, heuristic=cfg.heuristic)
            return
        if self.graph.entry < 0:
            # seed the very first node, then ALSO insert it normally below:
            # the seed must earn forward edges from its batch mates, or an
            # outlier seed is orphaned once the entry point moves off it
            hg.seed_first(self.graph, int(slots[0]), int(levels[0]))
            live = max(live, 1)
        hg.host_insert_stream(
            self.graph, st.vectors, st.norms, slots, levels,
            batch=max(1, cfg.batch_insert), live_before=live,
            efc=cfg.ef_construction, expand=max(1, cfg.expand_per_iter),
            heuristic=cfg.heuristic)

    def remove(self, vec_id: int) -> bool:
        """Tombstone + eager unlink; a removed entry point hands over to
        the live node of the highest level."""
        slot = self.store.remove(vec_id)
        if slot is None:
            return False
        if self._unpend_slot(slot):
            return True  # never reached the graph
        was_entry = self.graph.entry == slot
        hg.unlink_slot(self.graph, slot)
        if was_entry:
            fix_entry_after_unlink(self.graph, self.store.state.valid)
        return True

    def optimize_for_high_dimension(self) -> None:
        """Raise M / ef_construction / ef_search for very high-dimensional
        data (at dim >= 1000 and again at dim >= 1500).  Takes effect for
        vectors inserted afterwards; ``build()`` re-links the others."""
        cfg = self.config
        if self.dim >= 1500:
            cfg.m = max(cfg.m, 48)
            cfg.ef_construction = max(cfg.ef_construction, 600)
            cfg.ef_search = max(cfg.ef_search, 600)
        elif self.dim >= 1000:
            cfg.m = max(cfg.m, 40)
            cfg.ef_construction = max(cfg.ef_construction, 500)
            cfg.ef_search = max(cfg.ef_search, 500)
        if cfg.m > self.graph.m:
            # grow the adjacency width; existing edge lists are preserved
            self.graph.neighbors = torch.nn.functional.pad(
                self.graph.neighbors, (0, cfg.m - self.graph.m), value=-1)

    def build(self) -> None:
        """Full rebuild: a fresh graph, every live vector re-inserted in id
        order."""
        st = self.store.state
        ids_np = st.ids.cpu().numpy()
        live = np.flatnonzero(st.valid.cpu().numpy())
        order = live[np.argsort(ids_np[live], kind="stable")]
        self.graph = hg.init_graph(self.store.capacity, self.config.m,
                                   self._max_level, self.device)
        self._clear_pending()  # the rebuild connects everything
        if order.size:
            self._graph_insert(order.astype(np.int32))

    # --------------------------------------------------------------- search
    def search_batch(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = self._prep(as_queries(queries, self.dim, self.device))
        st = self.store.state
        n_live = self.store.size()
        padded, q_n = pad_queries_pow2(q)
        k_eff = max(1, min(k, st.capacity))
        k_pad = min(pow2(k_eff), st.capacity)

        if self.graph.entry < 0 or n_live <= k:
            dists, slots = blocked_knn(
                padded, st.vectors, st.valid, k_pad, metric="l2",
                b_norms=st.norms, block_n=min(8192, st.capacity))
        else:
            ef = min(max(self.config.ef_for_query(k_pad, n_live, self.dim),
                         k_pad), st.capacity)
            expand = max(1, self.config.expand_per_iter)
            if self._pending_count > 0:
                # deferred adds: graph beam + exact overlay over pending rows
                dists, slots = hg.hnsw_search_pending(
                    self.graph, st.vectors, st.norms, st.valid, padded,
                    self._pending_padded(), k_pad, ef, expand=expand)
            else:
                dists, slots = hg.hnsw_search(
                    self.graph, st.vectors, st.norms, st.valid, padded,
                    k_pad, ef, expand=expand)
        if self.metric == "cosine":
            # squared L2 over unit vectors = 2 (1 - cos): halve it so every
            # index reports cosine distance
            dists = dists * 0.5
        return to_host_results(q_n, k, k_eff, slots, st.ids, dists)

    # ---------------------------------------------------------------- state
    def size(self) -> int:
        return self.store.size()

    def get(self, vec_id: int) -> Optional[np.ndarray]:
        return self.store.get(vec_id)

    def stats(self) -> dict:
        """Level histogram and graph occupancy."""
        s = super().stats()
        levels = self.graph.levels.cpu().numpy()
        live = levels[levels >= 0]
        hist = {int(lv): int(c)
                for lv, c in zip(*np.unique(live, return_counts=True))}
        deg = (self.graph.neighbors[0] >= 0).sum(dim=1).cpu().numpy()
        s.update(
            m=self.config.m,
            ef_construction=self.config.ef_construction,
            ef_search=self.config.ef_search,
            max_level=self._max_level,
            entry_point=self.graph.entry,
            level_histogram=hist,
            avg_degree_l0=float(deg[levels >= 0].mean()) if live.size else 0.0,
            pending_inserts=int(self._pending_count),
            device=str(self.device),
        )
        return s

    # ------------------------------------------------------------ persistence
    def state_arrays(self) -> dict:
        self.flush_pending()  # checkpoints always hold a complete graph
        return {
            "store": self.store.to_host(),
            "graph": graph_to_host(self.graph),
            "level_counter": np.asarray([self._level_counter]),
        }

    def load_state_arrays(self, arrays: dict) -> None:
        """Load ``state_arrays()`` of either package onto this index's
        device."""
        self.store = VectorStore.from_host(arrays["store"], self.device)
        self._init_pending(self.store.capacity)  # checkpoints: complete graphs
        self.graph = graph_from_host(arrays["graph"], self.device)
        self._level_counter = int(np.asarray(arrays["level_counter"])[0])
