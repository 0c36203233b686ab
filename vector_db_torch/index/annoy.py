"""Annoy-style index: a forest of random-projection binary trees (the
counterpart of ``vector_db_tpu/index/annoy.py``).

The trees are arrays: ``hyperplanes [T, nodes, d]``, ``thresholds
[T, nodes]``, ``children [T, nodes, 2]``, ``node_leaf [T, nodes]`` and
fixed-width ``leaf_items [T, n_leaves, L]``.  They are built on the host by
the reference's level-synchronous numpy builder (copied, so the same f32
rows give the same trees); a search descends every tree with a margin beam
on the device, in query chunks under a byte budget (the per-level gather of
the beam's hyperplanes is [Q, T, beam, d]), and re-ranks the union of the
reached leaves exactly.  Pending rows (added since the last build) are
always candidates, so adds are visible before the rebuild.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.config import AnnoyConfig
from ..core.store import VectorStore
from ..ops.distance import blocked_knn, blocked_rerank, rerank_columns
from ..ops.topk import merge_topk
from .base import (VectorIndex, as_queries, backfill_short_rows,
                   pad_queries_pow2, pow2, to_host_results)

logger = logging.getLogger(__name__)

#: above this dimension random-projection trees lose discrimination: the
#: index warns once and the auto beam widens (the reference's threshold)
HIGH_DIM_THRESHOLD = 256
#: bytes of the [rows, T, beam, d] f32 hyperplane gather one descent
#: chunk makes per level
DESCEND_BYTES = 1 << 30


def descend_rows(t_n: int, beam: int, dim: int,
                 budget: int = DESCEND_BYTES) -> int:
    """Queries a descent chunk holds under ``budget`` bytes of gather."""
    return max(1, budget // (4 * t_n * beam * dim))


def _descend(queries: torch.Tensor, hyperplanes: torch.Tensor,
             thresholds: torch.Tensor, children: torch.Tensor,
             max_depth: int, beam: int) -> torch.Tensor:
    """Margin-beam descent from every root (node 0): [Q] queries x [T]
    trees, keeping per tree the ``beam`` branches of largest priority (the
    smallest split margin along the path; the near child inherits its
    parent's), equal priorities in position order.  Returns leaf nodes
    [Q, T, beam] int32, -1 in unused slots."""
    q_n, t_n = queries.shape[0], hyperplanes.shape[0]
    dev = queries.device
    node = torch.full((q_n, t_n, beam), -1, dtype=torch.int32, device=dev)
    node[:, :, 0] = 0
    prio = torch.full((q_n, t_n, beam), float("-inf"), device=dev)
    prio[:, :, 0] = float("inf")
    t_idx = torch.arange(t_n, device=dev)[None, :, None]
    for _ in range(max_depth):
        safe = node.clamp(min=0).long()
        live = node >= 0
        hp = hyperplanes[t_idx, safe]                          # [Q, T, B, d]
        proj = torch.bmm(hp.view(q_n, t_n * beam, -1),
                         queries[:, :, None]).view(q_n, t_n, beam)
        th = thresholds[t_idx, safe]
        margin = torch.abs(proj - th)
        go_right = proj > th
        ch = children[t_idx, safe]                             # [Q, T, B, 2]
        is_leaf = ch[..., 0] < 0
        near = torch.where(go_right, ch[..., 1], ch[..., 0])
        far = torch.where(go_right, ch[..., 0], ch[..., 1])
        stay = is_leaf | ~live
        near_n = torch.where(stay, node, near)
        near_p = torch.where(live, prio, float("-inf"))
        far_n = torch.where(stay, torch.full_like(far, -1), far)
        far_p = torch.where(live & ~is_leaf, torch.minimum(prio, margin),
                            float("-inf"))
        cand_n = torch.cat([near_n, far_n], dim=2)             # [Q, T, 2B]
        cand_p = torch.cat([near_p, far_p], dim=2)
        # the near child inherits its parent's priority, and so does a far
        # child whose margin exceeds it: ties are common, so a stable sort
        # keeps the lower position first, as the reference's top_k does
        prio, arg = torch.sort(cand_p, dim=2, descending=True, stable=True)
        prio, arg = prio[:, :, :beam], arg[:, :, :beam]
        node = torch.gather(cand_n, 2, arg)
        node = node.masked_fill_(prio == float("-inf"), -1)
    return node


def descend(queries: torch.Tensor, hyperplanes: torch.Tensor,
            thresholds: torch.Tensor, children: torch.Tensor,
            max_depth: int, beam: int, budget: int = DESCEND_BYTES
            ) -> torch.Tensor:
    """:func:`_descend` over query chunks of :func:`descend_rows` rows."""
    rows = descend_rows(hyperplanes.shape[0], beam, hyperplanes.shape[2],
                        budget)
    return torch.cat([_descend(queries[s:s + rows], hyperplanes, thresholds,
                               children, max_depth, beam)
                      for s in range(0, queries.shape[0], rows)])


def _rerank(queries: torch.Tensor, base: torch.Tensor, norms: torch.Tensor,
            valid: torch.Tensor, cand: torch.Tensor, k: int,
            metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of the candidate union [Q, C] (-1 padded, duplicates
    across trees): a sort drops the duplicates; past 8,192 candidates the
    blocks of ``blocked_rerank`` (at least the reference's 2,048 columns),
    else the reference's one-shot scoring from the stored norms.  Blocks
    follow ``ops/distance.rerank_columns``."""
    q_n, c = cand.shape
    cand = torch.sort(cand, dim=1)[0]
    dup = torch.zeros_like(cand, dtype=torch.bool)
    dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
    ok = ~dup & (cand >= 0) & valid[cand.clamp(min=0).long()]
    cand = torch.where(ok, cand, torch.full_like(cand, -1))
    if c > 8192:
        return blocked_rerank(queries, base, cand, k, metric,
                              rb=rerank_columns(q_n, base.shape[1], 2048))
    q_norms = torch.sum(queries * queries, dim=1)
    rb = min(c, rerank_columns(q_n, base.shape[1]))
    top_d = torch.full((q_n, k), float("inf"), device=queries.device)
    top_i = torch.full((q_n, k), -1, dtype=cand.dtype, device=queries.device)
    for start in range(0, c, rb):
        cnd = cand[:, start:start + rb]
        safe = cnd.clamp(min=0).long()
        cross = torch.bmm(base[safe], queries[:, :, None])[:, :, 0]
        if metric == "l2":
            d = torch.clamp(q_norms[:, None] + norms[safe] - 2.0 * cross,
                            min=0.0)
        else:  # cosine distance, the currency of every other index
            denom = torch.sqrt(torch.clamp(q_norms[:, None] * norms[safe],
                                           min=1e-12))
            d = 1.0 - cross / denom
        d = d.masked_fill_(cnd < 0, float("inf"))
        top_d, top_i = merge_topk(top_d, top_i, d, cnd, k)
    return top_d, top_i


def _build_tree_levels(
    data, live, leaf, rng, max_nodes, n_leaves,
    hps, ths, ch, node_leaf, leaves,
) -> int:
    """Build ONE tree breadth-first, splitting every active node per depth
    in vectorized numpy (a copy of the reference's builder).  Writes into
    the caller's per-tree array views; returns the max depth reached.

    Per depth: group points by node (one argsort), pick two random members
    per node for the hyperplane (normalized difference of two members),
    project ALL points against their node's hyperplane with one gathered
    row-dot, take per-node medians from a (group, proj) lexsort, split.
    Degenerate splits (all projections on one side of the median) force
    halves by rank."""
    n = data.shape[0]
    grp = np.zeros(n, np.int32)          # current node per point; -1 = done
    next_node = 1
    next_leaf = 0
    depth = 1
    while True:
        pts = np.flatnonzero(grp >= 0)
        if pts.size == 0:
            return depth
        order = pts[np.argsort(grp[pts], kind="stable")]
        sg = grp[order]
        n_act = order.size
        starts = np.flatnonzero(np.r_[True, sg[1:] != sg[:-1]])
        counts = np.diff(np.r_[starts, n_act])
        node_ids = sg[starts]
        room = max_nodes - next_node
        splittable = (counts > 2 * leaf) & (depth <= 40)
        # cap by remaining node budget (2 children per split)
        if int(splittable.sum()) * 2 > room:
            keep = np.flatnonzero(splittable)[: room // 2]
            splittable = np.zeros_like(splittable)
            splittable[keep] = True
        # finalize the rest as leaves, fully vectorized: each takes its
        # first 2*leaf members (contiguous in `order`); points of finalized
        # nodes leave the loop (grp = -1)
        fin = np.flatnonzero(~splittable)
        if fin.size:
            rows = next_leaf + np.arange(fin.size)
            ok = rows < n_leaves
            fin_w, rows = fin[ok], rows[ok]
            next_leaf += int(fin_w.size)
            width = 2 * leaf
            offs = starts[fin_w][:, None] + np.arange(width)[None, :]
            in_grp = offs < (starts[fin_w] + counts[fin_w])[:, None]
            vals = live[order[np.minimum(offs, n_act - 1)]]
            leaves[rows[:, None], np.arange(width)[None, :]] = np.where(
                in_grp, vals, -1
            )
            node_leaf[node_ids[fin_w]] = rows
        big = np.flatnonzero(splittable)
        if big.size == 0:
            return depth
        g_n = big.size
        cnt = counts[big]
        # two distinct random members per splitting node
        a_off = rng.integers(0, cnt)
        b_off = rng.integers(0, cnt - 1)
        b_off = np.where(b_off >= a_off, b_off + 1, b_off)
        pa = order[starts[big] + a_off]
        pb = order[starts[big] + b_off]
        hp = data[pa] - data[pb]                              # [G, d]
        nrm = np.linalg.norm(hp, axis=1)
        bad = nrm < 1e-9
        if bad.any():
            hp[bad] = rng.standard_normal(
                (int(bad.sum()), data.shape[1])).astype(np.float32)
            nrm[bad] = np.linalg.norm(hp[bad], axis=1)
        hp = (hp / nrm[:, None]).astype(np.float32)
        # dense local index per splitting node; non-splitting points -> -1
        gi_of_node = np.full(next_node, -1, np.int32)
        gi_of_node[node_ids[big]] = np.arange(g_n, dtype=np.int32)
        gi = np.where(grp >= 0, gi_of_node[np.maximum(grp, 0)], -1)
        act = np.flatnonzero(gi >= 0)         # points still in the loop
        proj = np.einsum("nd,nd->n", data[act], hp[gi[act]],
                         optimize=True).astype(np.float32)
        # per-node median + rank via one lexsort over (group, proj)
        ord2 = np.argsort(proj, kind="stable")
        ord2 = ord2[np.argsort(gi[act][ord2], kind="stable")]
        sp = act[ord2]                        # grouped by node, proj-sorted
        st2 = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        # numpy-median parity: even counts average the two middles
        proj_sorted = np.empty(n, np.float32)
        proj_sorted[act] = proj
        thr = 0.5 * (proj_sorted[sp[st2 + (cnt - 1) // 2]]
                     + proj_sorted[sp[st2 + cnt // 2]])
        right_act = proj > thr[gi[act]]
        # degenerate nodes (ties collapse one side): force halves by rank
        rank = np.empty(n, np.int64)
        rank[sp] = np.arange(sp.size) - st2.repeat(cnt)
        n_right = np.zeros(g_n, np.int64)
        np.add.at(n_right, gi[act], right_act)
        degen = (n_right == 0) | (n_right == cnt)
        if degen.any():
            force = degen[gi[act]]
            right_act = np.where(force, rank[act] >= (cnt // 2)[gi[act]],
                                 right_act)
        l_ids = (next_node + 2 * np.arange(g_n)).astype(np.int32)
        r_ids = l_ids + 1
        hps[node_ids[big]] = hp
        ths[node_ids[big]] = thr
        ch[node_ids[big], 0] = l_ids
        ch[node_ids[big], 1] = r_ids
        next_node += 2 * g_n
        new_grp = np.full(n, -1, np.int32)
        new_grp[act] = np.where(right_act, r_ids[gi[act]], l_ids[gi[act]])
        grp = new_grp
        depth += 1


class AnnoyIndex(VectorIndex):
    kind = "annoy"

    def __init__(self, dim: int, capacity: int, metric: str = "l2",
                 config: Optional[AnnoyConfig] = None, device="cuda"):
        super().__init__(dim, capacity, metric)
        self.config = config or AnnoyConfig()
        self.store = VectorStore(capacity, dim, device=device)
        self.device = self.store.device
        self.seed = 42
        self.rebuild_threshold = 1000  # pending adds that trigger a rebuild
        self._pending: list[int] = []  # slots not yet in the trees
        self._built = False
        self.hyperplanes: Optional[torch.Tensor] = None  # [T, nodes, d]
        self.thresholds: Optional[torch.Tensor] = None   # [T, nodes]
        self.children: Optional[torch.Tensor] = None     # [T, nodes, 2]
        self.leaf_items: Optional[torch.Tensor] = None   # [T, n_leaves, L]
        self.node_leaf: Optional[torch.Tensor] = None    # [T, nodes]
        self._max_depth = 1
        self._backfill_rows = 0
        self._backfill_queries = 0
        self._warned_high_dim = False

    # ------------------------------------------------------------- mutation
    def add_batch(self, ids: Sequence[int], vectors) -> list[int]:
        accepted, slots = self.store.add_batch(ids, vectors)
        self._pending.extend(slots)
        if len(self._pending) >= self.rebuild_threshold:
            self.build()
        return accepted

    def remove(self, vec_id: int) -> bool:
        slot = self.store.remove(vec_id)
        if slot is None:
            return False
        self._pending = [s for s in self._pending if s != slot]
        return True  # tombstone: the trees keep the slot, the re-rank drops it

    # --------------------------------------------------------------- build
    def build(self) -> None:
        """Rebuild the whole forest from the live rows on the host (one
        seeded numpy generator a tree), then move it to the device."""
        if self.dim > HIGH_DIM_THRESHOLD and not self._warned_high_dim:
            self._warned_high_dim = True
            logger.warning(
                "AnnoyIndex at dim=%d: random-projection trees lose "
                "discrimination at high dimension; the auto beam widens "
                "to 512 at a lower QPS: prefer HNSWPQ or LSH for "
                "dim > %d", self.dim, HIGH_DIM_THRESHOLD)
        live = np.flatnonzero(self.store.state.valid.cpu().numpy())
        self._pending.clear()
        if live.size < 2:
            self._built = False
            return
        data = self.store.state.vectors[
            torch.as_tensor(live, device=self.device)].cpu().numpy()
        t = self.config.num_trees
        leaf = max(2, self.config.leaf_size)
        n = live.size
        max_nodes = 4 * (2 * n // leaf + 2)
        n_leaves = 2 * n // leaf + 2

        hps = np.zeros((t, max_nodes, self.dim), np.float32)
        ths = np.zeros((t, max_nodes), np.float32)
        ch = np.full((t, max_nodes, 2), -1, np.int32)
        node_leaf = np.full((t, max_nodes), -1, np.int32)
        leaves = np.full((t, n_leaves, 2 * leaf), -1, np.int32)
        depth_max = 1
        for ti in range(t):
            depth_max = max(depth_max, _build_tree_levels(
                data, live, leaf, np.random.default_rng(self.seed + ti),
                max_nodes, n_leaves,
                hps[ti], ths[ti], ch[ti], node_leaf[ti], leaves[ti]))
        self._set_trees(hps, ths, ch, leaves, node_leaf)
        self._max_depth = depth_max + 1
        self._built = True

    def _set_trees(self, hps, ths, ch, leaves, node_leaf) -> None:
        def dev(a, dtype):
            return torch.tensor(np.asarray(a, dtype), device=self.device)
        self.hyperplanes = dev(hps, np.float32)
        self.thresholds = dev(ths, np.float32)
        self.children = dev(ch, np.int32)
        self.leaf_items = dev(leaves, np.int32)
        self.node_leaf = dev(node_leaf, np.int32)

    def beam(self) -> int:
        """The descent beam: ``config.search_k``, or the auto 128 (512
        above HIGH_DIM_THRESHOLD dims, where the trees discriminate less),
        at least 4."""
        auto_beam = 512 if self.dim > HIGH_DIM_THRESHOLD else 128
        return max(4, self.config.search_k or auto_beam)

    def candidates(self, queries: torch.Tensor) -> torch.Tensor:
        """The candidate union [Q, T * beam * L (+ pending)] of a padded
        batch: the items of every reached leaf, then the pending slots."""
        t_n = self.config.num_trees
        leaf_nodes = descend(queries, self.hyperplanes, self.thresholds,
                             self.children, self._max_depth,
                             self.beam())                     # [Q, T, B]
        t_idx = torch.arange(t_n, device=self.device)[None, :, None]
        rows = self.node_leaf[t_idx, leaf_nodes.clamp(min=0).long()]
        rows = rows.masked_fill_(leaf_nodes < 0, -1)
        items = self.leaf_items[t_idx, rows.clamp(min=0).long()]
        items = items.masked_fill_((rows < 0)[..., None], -1)
        cand = items.reshape(queries.shape[0], -1)
        if self._pending:
            pend = torch.as_tensor(np.unique(np.asarray(self._pending,
                                                        np.int32)),
                                   device=self.device)
            cand = torch.cat([cand, pend[None, :].expand(cand.shape[0], -1)],
                             dim=1)
        return cand

    # --------------------------------------------------------------- search
    def search_batch(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = as_queries(queries, self.dim, self.device)
        st = self.store.state
        padded, q_n = pad_queries_pow2(q)
        k_eff = min(k, st.capacity)
        k_pad = min(pow2(k_eff), st.capacity)
        if not self._built or self.store.size() <= k:
            dists, slots = blocked_knn(
                padded, st.vectors, st.valid, k_pad, metric=self.metric,
                b_norms=st.norms, block_n=min(8192, st.capacity))
            return to_host_results(q_n, k, k_eff, slots, st.ids, dists)
        dists, slots = _rerank(padded, st.vectors, st.norms, st.valid,
                               self.candidates(padded), k_pad, self.metric)
        dists, slots = backfill_short_rows(self, padded, q_n, k_eff, k_pad,
                                           dists, slots)
        return to_host_results(q_n, k, k_eff, slots, st.ids, dists)

    # ---------------------------------------------------------------- state
    def size(self) -> int:
        return self.store.size()

    def get(self, vec_id: int) -> Optional[np.ndarray]:
        return self.store.get(vec_id)

    def stats(self) -> dict:
        s = super().stats()
        s.update(
            num_trees=self.config.num_trees,
            leaf_size=self.config.leaf_size,
            built=self._built,
            pending=len(self._pending),
            max_depth=self._max_depth,
            backfill_rows=self._backfill_rows,
            backfill_queries=self._backfill_queries,
            high_dim=self.dim > HIGH_DIM_THRESHOLD,
        )
        return s

    # ------------------------------------------------------------ persistence
    def state_arrays(self) -> dict:
        out = {
            "store": self.store.to_host(),
            "built": np.asarray([self._built]),
            "pending": np.asarray(self._pending or [-1], np.int32),
            "max_depth": np.asarray([self._max_depth]),
        }
        if self._built:
            out["trees"] = {
                "hyperplanes": self.hyperplanes.cpu().numpy(),
                "thresholds": self.thresholds.cpu().numpy(),
                "children": self.children.cpu().numpy(),
                "leaf_items": self.leaf_items.cpu().numpy(),
                "node_leaf": self.node_leaf.cpu().numpy(),
            }
        return out

    def load_state_arrays(self, arrays: dict) -> None:
        self.store = VectorStore.from_host(arrays["store"], self.device)
        self._built = bool(np.asarray(arrays["built"])[0])
        pend = np.asarray(arrays["pending"])
        self._pending = [int(s) for s in pend if s >= 0]
        self._max_depth = int(np.asarray(arrays["max_depth"])[0])
        if self._built and "trees" in arrays:
            t = arrays["trees"]
            self._set_trees(t["hyperplanes"], t["thresholds"], t["children"],
                            t["leaf_items"], t["node_leaf"])
