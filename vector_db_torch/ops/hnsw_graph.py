"""HNSW graph engine: padded adjacency tensors and batched traversal (the
counterpart of ``vector_db_tpu/ops/hnsw_graph.py``, function by function).

Array-program form of HNSW:
  per-level adjacency maps  ->  neighbors [L, cap, M] int32, -1 padded
  visited sets              ->  a [Q, cap + 1] bool mask (the last column
                                takes the writes of masked entries)
  the beam's priority queue ->  a fixed-size sorted pool + expanded flags
  per-edge distances        ->  one gathered [Q, E*M, d] batched product

Design notes:
  * The greedy descent keeps a level counter per query, so all levels run
    in one loop.
  * Neighbor selection is the diversity heuristic (keep a candidate only if
    it is closer to the target than to every neighbor already kept, then
    backfill with the closest rejected ones); nearest-M is a switch.
  * Insertion runs in batched rounds against a frozen snapshot; batch
    members are merged into each other's candidates; the connect phase is
    sequential over the batch (a later node sees the earlier ones' reverse
    edges).
  * From-scratch builds (:func:`bulk_build`) and deferred adds
    (:func:`bulk_insert_delta`) use exact k-NN construction instead: one
    distance product a level, a batched prune, a grouped reverse pass.

What PyTorch changes.  The loops with a data-dependent end (the descent,
the beam) test their end on the host, which waits for the device; a step on
a query that is no longer alive changes nothing that survives, so the end is
tested every ``SYNC_EVERY`` steps.  ``entry`` and ``entry_level`` are Python
ints (every add and search reads them).  The tensors are updated in place:
a function that returns a graph returns the one it was given.  Writes
through index tensors never carry duplicate indices with different values
(masked entries are filtered out first, or land in a dump row or column).
Sorts are stable, as the reference's; ``torch.topk`` may order exact ties
differently, which matters only between rows at equal distance.  Selections
the reference makes with ``approx_max_k`` are exact ``torch.topk`` here.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .distance import blocked_knn_fast

#: steps of a data-dependent loop between two tests of its end on the host
SYNC_EVERY = 4

Dist = Callable[[torch.Tensor], torch.Tensor]


class HnswGraph:
    """Layered graph: the adjacency and the levels on the device, the entry
    point on the host."""

    __slots__ = ("neighbors", "levels", "entry", "entry_level")

    def __init__(self, neighbors: torch.Tensor, levels: torch.Tensor,
                 entry: int = -1, entry_level: int = -1):
        self.neighbors = neighbors  # [L, cap, M] int32 slot ids, -1 padded
        self.levels = levels        # [cap] int32 node top level, -1 absent
        self.entry = int(entry)     # entry point slot (-1 if empty)
        self.entry_level = int(entry_level)

    @property
    def max_level(self) -> int:
        return self.neighbors.shape[0]

    @property
    def capacity(self) -> int:
        return self.neighbors.shape[1]

    @property
    def m(self) -> int:
        return self.neighbors.shape[2]

    @property
    def device(self) -> torch.device:
        return self.neighbors.device


def init_graph(capacity: int, m: int, max_level: int, device) -> HnswGraph:
    return HnswGraph(
        torch.full((max_level, capacity, m), -1, dtype=torch.int32,
                   device=device),
        torch.full((capacity,), -1, dtype=torch.int32, device=device))


def sample_levels(gen: torch.Generator, n: int, m: int, max_level: int
                  ) -> torch.Tensor:
    """Geometric level assignment, mL = 1 / ln(M), from an explicit
    generator (on its own device)."""
    u = torch.rand(n, generator=gen, device=gen.device).clamp_(min=1e-12)
    ml = 1.0 / math.log(float(max(m, 2)))
    lv = torch.floor(-torch.log(u) * ml).to(torch.int32)
    return lv.clamp_(0, max_level - 1)


# --------------------------------------------------------------------------
# distance closures
# --------------------------------------------------------------------------

def _exact_dist(base: torch.Tensor, norms: torch.Tensor, q: torch.Tensor,
                q_norms: torch.Tensor) -> Dist:
    """dist(slots [Q, S]) -> [Q, S] exact squared L2; -1 slots -> +inf."""

    def dist(slots: torch.Tensor) -> torch.Tensor:
        safe = slots.clamp(min=0).long()
        dots = torch.bmm(base[safe], q[:, :, None])[:, :, 0]
        d = q_norms[:, None] + norms[safe] - 2.0 * dots
        return torch.where(slots >= 0, d.clamp_(min=0.0), float("inf"))

    return dist


def _adc_dist(codes: torch.Tensor, tables: torch.Tensor) -> Dist:
    """dist(slots [Q, S]) -> [Q, S] ADC distance from per-query tables
    [Q, M_sub, K]; -1 slots -> +inf."""

    def dist(slots: torch.Tensor) -> torch.Tensor:
        safe = slots.clamp(min=0).long()
        c = codes[safe].long().transpose(1, 2)        # [Q, M_sub, S]
        d = torch.sum(torch.gather(tables, 2, c), dim=1)
        return torch.where(slots >= 0, d, float("inf"))

    return dist


# --------------------------------------------------------------------------
# multi-level greedy descent
# --------------------------------------------------------------------------

def _greedy_descent(neighbors: torch.Tensor, dist: Dist, entry: torch.Tensor,
                    entry_d: torch.Tensor, start_level: torch.Tensor,
                    stop_level: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Walk greedily from ``start_level`` down to ``stop_level`` (inclusive)
    per query, all levels in one loop.

    neighbors [L, cap, M]; entry / entry_d [Q]; start / stop_level [Q]
    int32.  Returns (cur [Q], cur_d [Q]): the closest node found at
    stop_level.  A query past its stop level is inactive and its step
    changes nothing but its own level counter.
    """
    top = neighbors.shape[0] - 1
    cur, cur_d, lev = entry, entry_d, start_level
    step = 0
    while True:
        if step % SYNC_EVERY == 0 and not bool((lev >= stop_level).any()):
            break
        step += 1
        active = lev >= stop_level
        lev_c = lev.clamp(0, top).long()
        nbrs = neighbors[lev_c, cur.clamp(min=0).long()]          # [Q, M]
        nbrs = torch.where((cur >= 0)[:, None], nbrs, -1)
        d = dist(nbrs)
        best_d, best = torch.min(d, dim=1)
        best_i = torch.gather(nbrs, 1, best[:, None])[:, 0]
        better = active & (best_d < cur_d)
        cur = torch.where(better, best_i, cur)
        cur_d = torch.where(better, best_d, cur_d)
        # stuck at this level -> drop a level
        lev = torch.where(better, lev, lev - 1)
    return cur, cur_d


# --------------------------------------------------------------------------
# beam search on one level
# --------------------------------------------------------------------------

def _beam_level(neighbors: torch.Tensor, lev: int, dist: Dist,
                entry: torch.Tensor, entry_d: torch.Tensor,
                enabled: torch.Tensor, ef: int, max_iters: int, expand: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-first beam with a visited mask on level ``lev``.  ``enabled``
    [Q] masks out queries that skip this level.  Returns (pool_d [Q, ef],
    pool_i [Q, ef]) ascending, -1 padded.

    A step on a query that is no longer alive marks nothing expanded, finds
    nothing fresh and merges only +inf entries (whose slots become -1 at the
    end), so the end of the loop may be tested every ``SYNC_EVERY`` steps.
    The visited mask is allocated once a call; its extra last column takes
    the writes of entries that are not fresh, so every write is ``True``
    and repeated indices cannot disagree.
    """
    q_n = entry.shape[0]
    _, cap, m = neighbors.shape
    e = expand
    em = e * m
    dev = entry.device
    nbrs_lev = neighbors[lev]

    pool_d = torch.full((q_n, ef), float("inf"), device=dev)
    pool_d[:, 0] = entry_d
    pool_i = torch.full((q_n, ef), -1, dtype=torch.int32, device=dev)
    pool_i[:, 0] = entry
    pool_x = torch.zeros((q_n, ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((q_n, cap + 1), dtype=torch.bool, device=dev)
    visited.scatter_(1, entry.clamp(min=0).long()[:, None], True)
    earlier = torch.tril(torch.ones((em, em), dtype=torch.bool, device=dev),
                         diagonal=-1)                 # [j, j'] : j' < j
    alive = enabled
    inf = float("inf")

    for it in range(max_iters):
        if it % SYNC_EVERY == 0 and not bool(alive.any()):
            break
        sel_d = torch.where(pool_x | (pool_i < 0), inf, pool_d)
        top_d, sel = torch.topk(sel_d, e, dim=1, largest=False, sorted=True)
        sel_nodes = torch.gather(pool_i, 1, sel)                  # [Q, E]
        sel_ok = torch.isfinite(top_d)

        closest_unexp = top_d[:, 0]
        alive = alive & torch.isfinite(closest_unexp) \
            & (closest_unexp <= pool_d[:, -1])

        pool_x.scatter_(1, sel, torch.gather(pool_x, 1, sel)
                        | (sel_ok & alive[:, None]))

        nbrs = nbrs_lev[sel_nodes.clamp(min=0).long()]            # [Q, E, M]
        nbrs = torch.where((sel_nodes >= 0)[:, :, None], nbrs, -1
                           ).reshape(q_n, em)
        safe = nbrs.clamp(min=0).long()
        # dedup within the gathered frontier: two expanded candidates may
        # share a neighbor; both copies would pass the visited check and
        # put duplicates into the pool
        first_occ = ~torch.any(
            (nbrs[:, :, None] == nbrs[:, None, :]) & earlier[None], dim=2)
        fresh = (nbrs >= 0) & first_occ & ~torch.gather(visited, 1, safe) \
            & alive[:, None]
        visited.scatter_(1, torch.where(fresh, safe, cap), True)
        new_i = torch.where(fresh, nbrs, -1)
        d = dist(new_i)

        cat_d = torch.cat([pool_d, d], dim=1)
        cat_i = torch.cat([pool_i, new_i], dim=1)
        cat_x = torch.cat([pool_x, torch.zeros_like(fresh)], dim=1)
        pool_d, arg = torch.topk(cat_d, ef, dim=1, largest=False, sorted=True)
        pool_i = torch.gather(cat_i, 1, arg)
        pool_x = torch.gather(cat_x, 1, arg)

    pool_i = torch.where(torch.isfinite(pool_d), pool_i, -1)
    return pool_d, pool_i


# --------------------------------------------------------------------------
# neighbor selection
# --------------------------------------------------------------------------

def _select_heuristic(cand_d: torch.Tensor, cand_i: torch.Tensor,
                      pair_d: torch.Tensor, m: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Diversity-heuristic neighbor selection, batched over B targets: keep
    a candidate only if it is closer to the target than to every neighbor
    already kept; backfill the remaining slots with the closest rejected.

    cand_d [B, C] target -> candidate distances (inf for invalid); cand_i
    [B, C] candidate slots (-1 invalid); pair_d [B, C, C] candidate ->
    candidate distances.  Returns (sel_d [B, m], sel_i [B, m]).
    """
    b, c = cand_d.shape
    order = torch.argsort(cand_d, dim=1, stable=True)
    s_d = torch.gather(cand_d, 1, order)
    s_i = torch.gather(cand_i, 1, order)
    p = torch.gather(
        torch.gather(pair_d, 1, order[:, :, None].expand(-1, -1, c)),
        2, order[:, None, :].expand(-1, c, -1))       # sorted pairwise
    usable = torch.isfinite(s_d) & (s_i >= 0)
    # The greedy pass, two launches a candidate: ``keep`` starts as the
    # usable candidates; candidate i, if still kept when its turn comes,
    # strikes every later candidate j that is closer to i than to the
    # target.  The first m survivors are the reference's selection: its
    # "room left" test only rejects what comes after the m-th kept one, and
    # a rejected candidate strikes nobody.
    later = torch.ones((c, c), dtype=torch.bool, device=cand_d.device).triu(1)
    spares = ~((p < s_d[:, :, None]).transpose(1, 2) & later)   # [b, i, j]
    keep = usable
    for i in range(c):
        keep = torch.where(keep[:, i, None], keep & spares[:, i, :], keep)
    keep = keep & (torch.cumsum(keep, dim=1) <= m)

    # kept first (by distance), then the closest rejected as backfill
    rank = torch.arange(c, device=cand_d.device).expand(b, c)
    key = torch.where(keep, rank, rank + c)
    key = torch.where(usable, key, 2 * c)
    sel = torch.argsort(key, dim=1, stable=True)[:, :m]
    good = torch.gather(key, 1, sel) < 2 * c
    return (torch.where(good, torch.gather(s_d, 1, sel), float("inf")),
            torch.where(good, torch.gather(s_i, 1, sel), -1))


def _pairwise_among(base: torch.Tensor, norms: torch.Tensor,
                    slots: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2 among gathered slots: slots [B, C] -> [B, C, C],
    formed as ``n + n - 2 dot`` (the heuristic compares it with distances
    formed the same way)."""
    safe = slots.clamp(min=0).long()
    v = base[safe]                                    # [B, C, d]
    n = norms[safe]                                   # [B, C]
    dots = torch.bmm(v, v.transpose(1, 2))
    return (n[:, :, None] + n[:, None, :] - 2.0 * dots).clamp_(min=0.0)


def _masked_pairwise(base, norms, idx):
    """:func:`_pairwise_among` with +inf wherever either slot is -1."""
    ok = idx >= 0
    return torch.where(ok[:, :, None] & ok[:, None, :],
                       _pairwise_among(base, norms, idx), float("inf"))


def _nearest_m(cand_d, cand_i, m):
    """Plain nearest-``m`` selection (``heuristic=False``)."""
    d, arg = torch.topk(cand_d, m, dim=1, largest=False, sorted=True)
    return d, torch.where(torch.isfinite(d), torch.gather(cand_i, 1, arg), -1)


# --------------------------------------------------------------------------
# full multi-level search (exact distances: plain HNSW)
# --------------------------------------------------------------------------

def _descend_and_beam(graph: HnswGraph, dist: Dist, q_n: int, ef: int,
                      max_iters: int, expand: int):
    """Greedy descent from the entry point to level 1, then the ef-beam on
    level 0: (pool_d [Q, ef], pool_i [Q, ef])."""
    dev = graph.device
    entry = torch.full((q_n,), graph.entry, dtype=torch.int32, device=dev)
    entry_d = dist(entry[:, None])[:, 0]
    start = torch.full((q_n,), graph.entry_level, dtype=torch.int32,
                       device=dev)
    stop = torch.ones((q_n,), dtype=torch.int32, device=dev)
    cur, cur_d = _greedy_descent(graph.neighbors, dist, entry, entry_d,
                                 start, stop)
    return _beam_level(graph.neighbors, 0, dist, cur, cur_d,
                       torch.ones((q_n,), dtype=torch.bool, device=dev),
                       ef, max_iters, expand)


def hnsw_search(graph: HnswGraph, base: torch.Tensor, norms: torch.Tensor,
                valid: torch.Tensor, queries: torch.Tensor, k: int, ef: int,
                expand: int = 4, max_iters: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Layered search: greedy descent to level 1, ef-beam on level 0, top-k.
    Deleted slots stay traversable (tombstones) but are filtered from the
    results.  Returns (dists [Q, k], slots [Q, k]) ascending, -1 padded."""
    q_norms = torch.sum(queries * queries, dim=1)
    dist = _exact_dist(base, norms, queries, q_norms)
    pool_d, pool_i = _descend_and_beam(
        graph, dist, queries.shape[0], ef, max_iters if max_iters > 0 else ef,
        expand)
    ok = (pool_i >= 0) & valid[pool_i.clamp(min=0).long()]
    pool_d = torch.where(ok, pool_d, float("inf"))
    return _nearest_m(pool_d, pool_i, k)


def hnsw_search_pending(graph: HnswGraph, base: torch.Tensor,
                        norms: torch.Tensor, valid: torch.Tensor,
                        queries: torch.Tensor, pending: torch.Tensor, k: int,
                        ef: int, expand: int = 4, max_iters: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`hnsw_search` plus an exact overlay over deferred slots
    (``pending`` [P], -1 padded): rows buffered outside the graph under the
    defer insert policy are scored exactly and merged with the beam's
    answers, so results never lag the store.  Pending slots are disjoint
    from graph nodes, so the merge cannot duplicate ids."""
    d_g, i_g = hnsw_search(graph, base, norms, valid, queries, k=k, ef=ef,
                           expand=expand, max_iters=max_iters)
    safe = pending.clamp(min=0).long()
    q_norms = torch.sum(queries * queries, dim=1)
    d_p = q_norms[:, None] + norms[safe][None, :] \
        - 2.0 * (queries @ base[safe].T)
    ok = (pending >= 0) & valid[safe]
    d_p = torch.where(ok[None, :], d_p.clamp_(min=0.0), float("inf"))
    d_p, i_p = _nearest_m(d_p, pending[None, :].expand(d_p.shape[0], -1),
                          min(k, d_p.shape[1]))
    return _nearest_m(torch.cat([d_g, d_p], dim=1),
                      torch.cat([i_g, i_p.to(i_g.dtype)], dim=1), k)


# --------------------------------------------------------------------------
# batched insertion
# --------------------------------------------------------------------------

def insert_batch(graph: HnswGraph, base: torch.Tensor, norms: torch.Tensor,
                 new_slots, new_levels, efc: int, expand: int = 4,
                 heuristic: bool = True) -> HnswGraph:
    """Insert B nodes (slots and sampled levels, host int arrays [B]; the
    rows are already in the store) against a frozen snapshot, then connect
    them one after another.  The graph must be non-empty (the caller seeds
    the first node).

    Phase A descends through the levels above each node's own; phase B runs
    a beam a level (top -> 0, all nodes of the batch at once) and selects
    each node's neighbors among the beam's pool and its batch mates; phase C
    writes the forward edges and re-prunes the reverse ones, node by node in
    batch order.  Levels no node of the batch reaches, or above the entry
    level, are skipped: their step would select nothing.  In phase C the
    levels of one node touch disjoint ``neighbors[lev]`` and go as one batch.
    """
    slots_h = np.asarray(new_slots, np.int64)
    levels_h = np.asarray(new_levels, np.int64)
    b = slots_h.shape[0]
    L, cap, m = graph.neighbors.shape
    dev = graph.device
    slots_t = torch.as_tensor(slots_h, device=dev)
    new_slots_t = slots_t.to(torch.int32)
    new_levels_t = torch.as_tensor(levels_h, device=dev).to(torch.int32)
    q = base[slots_t]
    q_norms = torch.sum(q * q, dim=1)
    dist = _exact_dist(base, norms, q, q_norms)

    # batch-mate distances; self AND duplicate slots are excluded (rounds
    # are padded by repeating the last slot)
    mate_d = (q_norms[:, None] + q_norms[None, :] - 2.0 * (q @ q.T)
              ).clamp_(min=0.0)
    distinct = new_slots_t[None, :] != new_slots_t[:, None]

    graph.levels[slots_t] = new_levels_t

    # ---- phase A: greedy descent through the levels without edges ---------
    entry = torch.full((b,), graph.entry, dtype=torch.int32, device=dev)
    entry_d = dist(entry[:, None])[:, 0]
    start = torch.full((b,), graph.entry_level, dtype=torch.int32, device=dev)
    stop = torch.clamp(new_levels_t, max=graph.entry_level) + 1
    cur, cur_d = _greedy_descent(graph.neighbors, dist, entry, entry_d,
                                 start, stop)

    # ---- phase B: per-level beam + neighbor selection (top -> 0) ----------
    c_sel = min(max(3 * m, m + 1), efc + b)  # heuristic candidate pool width
    selected = torch.full((b, L, m), -1, dtype=torch.int32, device=dev)
    mates_i = new_slots_t[None, :].expand(b, b)
    for lev in range(min(graph.entry_level, int(levels_h.max())), -1, -1):
        do_beam = new_levels_t >= lev
        pool_d, pool_i = _beam_level(graph.neighbors, lev, dist, cur, cur_d,
                                     do_beam, efc, efc, expand)
        mate_ok = (new_levels_t[None, :] >= lev) & distinct
        cand_d = torch.cat([pool_d, torch.where(mate_ok, mate_d,
                                                float("inf"))], dim=1)
        cand_i = torch.cat([pool_i, mates_i], dim=1)
        cand_d = torch.where(cand_i >= 0, cand_d, float("inf"))
        # a node must never select itself (it is in the frozen graph when it
        # doubles as the seed, and padded rounds repeat slots)
        cand_d = torch.where(cand_i == new_slots_t[:, None], float("inf"),
                             cand_d)
        # pre-trim to the heuristic pool width
        c_d, c_i = _nearest_m(cand_d, cand_i, c_sel)
        if heuristic:
            _, sel_i = _select_heuristic(
                c_d, c_i, _pairwise_among(base, norms, c_i), m)
        else:
            sel_i = c_i[:, :m]
        selected[:, lev, :] = torch.where(do_beam[:, None], sel_i,
                                          selected[:, lev, :])
        cur = torch.where(do_beam, pool_i[:, 0], cur)
        cur_d = torch.where(do_beam, pool_d[:, 0], cur_d)

    # ---- phase C: connect, one node after another -------------------------
    nbrs_arr = graph.neighbors
    for i in range(b):
        slot_i = int(slots_h[i])
        nl = min(int(levels_h[i]), L - 1) + 1         # levels 0 .. nl - 1
        lv = torch.arange(nl, device=dev)
        sel = selected[i, :nl]                                    # [nl, M]
        nbrs_arr[:nl, slot_i] = sel                   # forward edges
        # reverse edges, re-pruned: each selected neighbor takes the new
        # node into its list and keeps its best M
        tgt = sel.reshape(-1)                                     # [nl*M]
        safe_t = tgt.clamp(min=0).long()
        lev_t = lv.repeat_interleave(m)
        cur_lists = nbrs_arr[lev_t, safe_t]                       # [nl*M, M]
        cand = torch.cat(
            [torch.where(cur_lists == slot_i, -1, cur_lists),
             torch.full((nl * m, 1), slot_i, dtype=torch.int32, device=dev)],
            dim=1)                                                # [nl*M, M+1]
        c_safe = cand.clamp(min=0).long()
        dd = norms[safe_t][:, None] + norms[c_safe] - 2.0 * torch.bmm(
            base[c_safe], base[safe_t][:, :, None])[:, :, 0]
        dd = torch.where(cand >= 0, dd.clamp_(min=0.0), float("inf"))
        if heuristic:
            _, new_lists = _select_heuristic(
                dd, cand, _pairwise_among(base, norms, cand), m)
        else:
            _, new_lists = _nearest_m(dd, cand, m)
        # a masked target (-1) rewrites the node's own forward row with the
        # list it already holds: repeated indices then carry equal values,
        # and row 0 is written only where it is a real target
        real = tgt >= 0
        nbrs_arr[lev_t, torch.where(real, safe_t, slot_i)] = torch.where(
            real[:, None], new_lists, sel.repeat_interleave(m, dim=0))

    # entry-point promotion
    best = int(np.argmax(levels_h))
    if int(levels_h[best]) > graph.entry_level:
        graph.entry = int(slots_h[best])
        graph.entry_level = int(levels_h[best])
    return graph


def insert_rounds(graph: HnswGraph, base: torch.Tensor, norms: torch.Tensor,
                  slots, levels, efc: int, expand: int = 4,
                  heuristic: bool = True) -> HnswGraph:
    """R :func:`insert_batch` rounds of B slots each (``slots``, ``levels``
    [R, B] host arrays).  Rounds are padded by repeating slots:
    re-inserting a node just recomputes its edges against the current
    graph."""
    for s, lv in zip(np.asarray(slots), np.asarray(levels)):
        insert_batch(graph, base, norms, s, lv, efc, expand, heuristic)
    return graph


def _bulk_level_edges(member_vecs: torch.Tensor, member_norms: torch.Tensor,
                      member_slots: torch.Tensor, m: int,
                      heuristic: bool = True, k_cand: int = 0
                      ) -> torch.Tensor:
    """Exact-kNN edge construction for ONE level: a members x members
    distance product -> top-(2m+1) candidates -> diversity prune -> a
    sort-based reverse-edge pass -> final prune.

    member_vecs [Nl, d] (padded rows allowed), member_norms [Nl] (+inf on
    padding), member_slots [Nl] global slots (-1 padding); Nl is a multiple
    of min(4096, Nl).  Returns the local adjacency [Nl, m] of LOCAL member
    indices (-1 padded); the caller maps them to global slots.
    """
    nl = member_vecs.shape[0]
    dev = member_vecs.device
    c = k_cand if k_cand > 0 else min(2 * m + 1, nl)
    valid = member_slots >= 0
    # the query axis goes in chunks so the [CQ, Nl] distance tile stays
    # bounded (one [Nl, Nl] matrix is 40 GB at Nl = 100k)
    cq = min(4096, nl)
    starts = range(0, nl // cq * cq, cq)

    def prune(cand_d, cand_i):
        m_eff = min(m, cand_i.shape[1])
        if heuristic:
            _, sel = _select_heuristic(
                cand_d, cand_i,
                _masked_pairwise(member_vecs, member_norms, cand_i), m_eff)
        else:
            _, sel = _nearest_m(cand_d, cand_i, m_eff)
        if m_eff < m:  # tiny levels: fewer candidates than M slots
            sel = torch.nn.functional.pad(sel, (0, m - m_eff), value=-1)
        return sel

    d_l, idx_l = [], []
    for s in starts:
        qv = member_vecs[s:s + cq]
        qn = torch.sum(qv * qv, dim=1)
        dists = qn[:, None] + member_norms[None, :] - 2.0 * (qv @ member_vecs.T)
        dists = torch.where(valid[None, :], dists.clamp_(min=0.0),
                            float("inf"))
        dd, ii = torch.topk(dists, c, dim=1, largest=False, sorted=True)
        ii = ii.to(torch.int32)
        is_self = ii == torch.arange(s, s + cq, dtype=torch.int32,
                                     device=dev)[:, None]
        dd = torch.where(is_self, float("inf"), dd)
        d_l.append(dd)
        idx_l.append(torch.where(is_self | ~torch.isfinite(dd), -1, ii))
    d = torch.cat(d_l)
    idx = torch.cat(idx_l)
    fwd = torch.cat([prune(d[s:s + cq], idx[s:s + cq]) for s in starts])

    # ---- reverse pass: u -> v means v should consider u -------------------
    tgt = fwd.reshape(-1)                                         # [Nl*m]
    src = torch.arange(nl, dtype=torch.int32, device=dev).repeat_interleave(m)
    ok = tgt >= 0
    sort_key = torch.where(ok, tgt, nl)
    order = torch.argsort(sort_key, stable=True)
    s_tgt = sort_key[order]
    s_src = torch.where(ok[order], src[order], -1)
    # position within the run of equal targets: positions ascend, so the
    # running maximum of the runs' first positions is each entry's run start
    first = torch.ones_like(ok)
    first[1:] = s_tgt[1:] != s_tgt[:-1]
    pos_global = torch.arange(s_tgt.shape[0], dtype=torch.int32, device=dev)
    run_start = torch.cummax(torch.where(first, pos_global, 0), dim=0)[0]
    pos = pos_global - run_start
    keep = (s_tgt < nl) & (pos < m) & (s_src >= 0)
    # dropped entries land in the dump row nl; kept (target, position)
    # pairs are unique
    rev = torch.full((nl + 1, m), -1, dtype=torch.int32, device=dev)
    rev[torch.where(keep, s_tgt, nl).long(),
        torch.where(keep, pos, 0).long()] = s_src
    rev = rev[:nl]

    # ---- final: prune(top-c kNN + reverse sources), chunked ---------------
    final = []
    for s in starts:
        rv = rev[s:s + cq]
        diff = member_vecs[rv.clamp(min=0).long()] \
            - member_vecs[s:s + cq, None, :]
        rev_d = torch.where(rv >= 0, torch.sum(diff * diff, dim=2),
                            float("inf"))
        cand_d = torch.cat([d[s:s + cq], rev_d], dim=1)
        cand_i = torch.cat([idx[s:s + cq], rv], dim=1)
        # dedup (a reverse source may already be a kNN candidate): sort by
        # id, mask adjacent duplicates
        ordc = torch.argsort(torch.where(cand_i >= 0, cand_i, nl + 1), dim=1,
                             stable=True)
        c_i = torch.gather(cand_i, 1, ordc)
        c_d = torch.gather(cand_d, 1, ordc)
        dup = torch.zeros_like(c_i, dtype=torch.bool)
        dup[:, 1:] = c_i[:, 1:] == c_i[:, :-1]
        c_d = torch.where(dup | (c_i < 0), float("inf"), c_d)
        c_i = torch.where(dup, -1, c_i)
        final.append(prune(c_d, c_i))
    return torch.where(valid[:, None], torch.cat(final), -1)


def _pad_pow2(slots_np: np.ndarray) -> np.ndarray:
    """Slots padded with -1 to a power of two, at least 8 (the reference's
    level shapes, kept so both packages chunk a level alike)."""
    n_pad = max(8, 1 << int(np.ceil(np.log2(slots_np.size))))
    return np.concatenate(
        [slots_np, np.full(n_pad - slots_np.size, -1, np.int32)])


def bulk_build(graph: HnswGraph, base: torch.Tensor, norms: torch.Tensor,
               slots, levels, m: int, heuristic: bool = True) -> HnswGraph:
    """Build the whole layered graph from scratch with exact-kNN
    construction (:func:`_bulk_level_edges` a level) in place of thousands
    of sequential insertion beams.  ``slots`` / ``levels``: host int arrays
    [n] of the live slots and their sampled levels."""
    levels_np = np.asarray(levels)
    slots_np = np.asarray(slots, np.int32)
    dev = graph.device
    graph.levels[torch.as_tensor(slots_np, device=dev).long()] = \
        torch.as_tensor(levels_np, device=dev).to(torch.int32)

    for lev in range(graph.max_level):
        members = slots_np[levels_np >= lev]
        if members.size == 0:
            break
        if members.size == 1:
            continue
        mem = torch.as_tensor(_pad_pow2(members), device=dev)
        safe = mem.clamp(min=0).long()
        nrm = torch.where(mem >= 0, norms[safe], float("inf"))
        local = _bulk_level_edges(base[safe], nrm, mem, m, heuristic)
        # local member indices -> global slots; only the members' own rows
        # are written (a pad would alias slot 0 and clobber its fresh row)
        glob = torch.where(local >= 0, mem[local.clamp(min=0).long()], -1)
        graph.neighbors[lev, safe[:members.size]] = glob[:members.size]

    top = int(levels_np.max()) if levels_np.size else 0
    entries = slots_np[levels_np == top]
    graph.entry = int(entries[0]) if entries.size else int(slots_np[0])
    graph.entry_level = top
    return graph


def host_insert_stream(graph: HnswGraph, base: torch.Tensor,
                       norms: torch.Tensor, slots, levels, batch: int,
                       live_before: int, efc: int, expand: int = 4,
                       heuristic: bool = True) -> HnswGraph:
    """A whole insertion stream (host int arrays [n]).

    Growth rounds first: while the graph is tiny the round size follows the
    live graph size (1, 2, 4, ... up to ``batch``), so early nodes keep
    links to each other; then full rounds of ``batch``, the last padded by
    repeating its last slot.
    """
    slots = np.asarray(slots)
    levels = np.asarray(levels)
    n = len(slots)
    pos = 0
    live = max(live_before, 1)
    b = max(1, batch)

    def pad_round(chunk, step):
        return np.concatenate([chunk, np.repeat(chunk[-1:], step - len(chunk))])

    while pos < n and live < b:
        step = min(b, 1 << (max(live, 1).bit_length() - 1))
        insert_batch(graph, base, norms,
                     pad_round(slots[pos:pos + step], step),
                     pad_round(levels[pos:pos + step], step),
                     efc=efc, expand=expand, heuristic=heuristic)
        pos += min(step, n - pos)
        live += step

    if pos < n:
        num_rounds = -(-(n - pos) // b)
        insert_rounds(
            graph, base, norms,
            pad_round(slots[pos:], num_rounds * b).reshape(num_rounds, b),
            pad_round(levels[pos:], num_rounds * b).reshape(num_rounds, b),
            efc=efc, expand=expand, heuristic=heuristic)
    return graph


# --------------------------------------------------------------------------
# exact-kNN delta insertion (deferred incremental adds)
# --------------------------------------------------------------------------

def _delta_level_edges(nbrs_lev: torch.Tensor, base: torch.Tensor,
                       norms: torch.Tensor, member_mask: torch.Tensor,
                       new_slots: torch.Tensor, m: int, heuristic: bool,
                       c: int, rev_inc: int, block_n: int,
                       rev_chunk: int = 2048) -> torch.Tensor:
    """One level of exact-kNN DELTA insertion: connect ``new_slots`` ([Nn]
    int32, -1 padded) into this level's adjacency ``nbrs_lev`` [cap, M] in
    place, touching no unaffected row.

    One blocked distance scan finds every new node's true top-c neighbors
    among the level's members (``member_mask`` [cap], old and new: the new
    nodes see each other, so edges inside the batch form on both sides), a
    batched diversity prune picks the forward edges, and a grouped reverse
    pass re-prunes each affected old row once, with its ``rev_inc`` closest
    incoming sources.  Like :func:`insert_batch` it connects against a
    frozen snapshot.  Only the real new slots and the first row of each
    target's run are written, so no index is written twice.
    """
    cap = base.shape[0]
    nn = new_slots.shape[0]
    dev = base.device
    qv = base[new_slots.clamp(min=0).long()]                      # [Nn, d]

    # ---- forward: true top-c among the members, diversity prune -----------
    d, idx = blocked_knn_fast(qv, base, member_mask, c, "l2", b_norms=norms,
                              block_n=block_n)
    drop = (idx == new_slots[:, None]) | (new_slots < 0)[:, None]
    d = torch.where(drop, float("inf"), d)
    idx = torch.where(drop | ~torch.isfinite(d), -1, idx)
    if heuristic:
        sel_d, sel_i = _select_heuristic(
            d, idx, _masked_pairwise(base, norms, idx), m)
    else:
        sel_d, sel_i = _nearest_m(d, idx, m)
    real = torch.nonzero(new_slots >= 0)[:, 0]
    nbrs_lev[new_slots[real].long()] = sel_i[real]

    # ---- reverse: group (new u -> old v) edges by target, re-prune v ------
    # edges sorted by (target, distance): each target's closest incoming
    # sources sit in one run, and the first row of the run re-prunes that
    # target once with up to rev_inc incoming candidates
    flat_t = sel_i.reshape(-1)                                    # [T]
    flat_s = new_slots[:, None].expand(nn, m).reshape(-1)
    flat_d = sel_d.reshape(-1)
    t_tot = flat_t.shape[0]
    ok = (flat_t >= 0) & (flat_s >= 0)
    key_t = torch.where(ok, flat_t, cap)
    by_d = torch.argsort(flat_d, stable=True)
    order = by_d[torch.argsort(key_t[by_d], stable=True)]
    s_t = key_t[order]
    s_s = torch.where(ok[order], flat_s[order], -1)
    first = torch.ones_like(ok)
    first[1:] = s_t[1:] != s_t[:-1]
    first &= s_t < cap
    # windowed incoming: row p sees sources p .. p + rev_inc - 1 of its run
    s_s_pad = torch.cat([s_s, torch.full((rev_inc,), -1, dtype=torch.int32,
                                         device=dev)])
    s_t_pad = torch.cat([s_t, torch.full((rev_inc,), cap, dtype=torch.int32,
                                         device=dev)])
    inc = torch.stack(
        [torch.where(s_t_pad[j:j + t_tot] == s_t, s_s_pad[j:j + t_tot], -1)
         for j in range(rev_inc)], dim=1)                         # [T, rev_inc]

    rows = torch.nonzero(first)[:, 0]     # one row a target: unique targets
    for s in range(0, rows.shape[0], rev_chunk):
        sl = rows[s:s + rev_chunk]
        tg = s_t[sl].long()
        ic = inc[sl]
        cur = nbrs_lev[tg]                                        # [B, M]
        # dedup: an incoming source may already be an edge of the target
        dup_cur = torch.any(
            (cur[:, :, None] == ic[:, None, :]) & (ic[:, None, :] >= 0), dim=2)
        cand = torch.cat([torch.where(dup_cur, -1, cur), ic], dim=1)
        c_safe = cand.clamp(min=0).long()
        dd = norms[tg][:, None] + norms[c_safe] - 2.0 * torch.bmm(
            base[c_safe], base[tg][:, :, None])[:, :, 0]
        dd = torch.where(cand >= 0, dd.clamp_(min=0.0), float("inf"))
        if heuristic:
            _, new_rows = _select_heuristic(
                dd, cand, _masked_pairwise(base, norms, cand), m)
        else:
            _, new_rows = _nearest_m(dd, cand, m)
        nbrs_lev[tg] = new_rows
    return nbrs_lev


def bulk_insert_delta(graph: HnswGraph, base: torch.Tensor,
                      norms: torch.Tensor, valid: torch.Tensor, slots,
                      levels, m: int, heuristic: bool = True) -> HnswGraph:
    """Connect a batch of new nodes (host int arrays [n]; rows already in
    the store) into an EXISTING graph with exact-kNN delta construction,
    :func:`_delta_level_edges` a level: the flush of the deferred-insert
    policy.  Rows the batch does not touch stay as they are, unlike
    :func:`bulk_build`, which rebuilds every edge."""
    levels_np = np.asarray(levels)
    slots_np = np.asarray(slots, np.int32)
    if slots_np.size == 0:
        return graph
    dev = graph.device
    graph.levels[torch.as_tensor(slots_np, device=dev).long()] = \
        torch.as_tensor(levels_np, device=dev).to(torch.int32)
    member_base = valid & (graph.levels >= 0)
    m_eff = graph.m
    cap = graph.capacity
    top_new = int(levels_np.max())

    for lev in range(min(top_new + 1, graph.max_level)):
        mine = slots_np[levels_np >= lev]
        if mine.size == 0:
            break
        _delta_level_edges(
            graph.neighbors[lev], base, norms,
            member_base & (graph.levels >= lev),
            torch.as_tensor(_pad_pow2(mine), device=dev),
            m=m_eff, heuristic=heuristic, c=min(2 * m_eff + 2, cap),
            rev_inc=min(m_eff, 16), block_n=min(262144, cap))

    if top_new > graph.entry_level:
        graph.entry = int(slots_np[int(np.argmax(levels_np))])
        graph.entry_level = top_new
    return graph


def seed_first(graph: HnswGraph, slot: int, level: int) -> HnswGraph:
    """Insert the very first node (the caller decides when the graph is
    empty)."""
    graph.levels[int(slot)] = int(level)
    graph.entry = int(slot)
    graph.entry_level = int(level)
    return graph


def unlink_slot(graph: HnswGraph, slot: int) -> HnswGraph:
    """Remove a node's edges and every pointer to it (one pass over the
    whole [L, cap, M] adjacency).  The caller fixes the entry point up."""
    graph.neighbors.masked_fill_(graph.neighbors == int(slot), -1)
    graph.neighbors[:, int(slot), :] = -1
    graph.levels[int(slot)] = -1
    return graph
