"""The cluster-pruned scan tier, ``search_mode="scan_ivf"`` (the
counterpart of ``vector_db_tpu/ops/ivf_scan.py``).

  1. a coarse k-means quantizer (the index's ``nlist`` centroids)
     partitions the corpus;
  2. a balanced cluster-major layout places every live row at one position
     of a dense [nlist, cap] grid, spilling k-means' skew to each row's
     next-best cluster (:func:`balanced_layout_dev`), so every cluster is
     one [cap, d] tile;
  3. per batch, each query picks its ``nprobe`` nearest clusters, the
     (query, cluster) relation is inverted into per-cluster prober tiles
     (:func:`invert_probers`), and one kernel scores every probed cluster
     against its own prober tile (``ops/kernels.fused_ivf_pool``);
  4. each query gathers its pools back, one exact select ranks the union,
     and the caller's refine finishes (:func:`ivf_pool_candidates`).

The reference's approximate selects (``approx_max_k`` for the probes and
the merge) are exact ``torch.topk`` here, and its sorted worklist of probed
clusters is a per-cluster prober count built on the device
(:func:`prober_counts`): the kernel skips unprobed clusters and the prober
tiles past each count without a host round trip.
"""

from __future__ import annotations

import torch

from .distance import normalize_rows, words_to_f32
from .kernels import IVF_PW, LANES, fused_ivf_pool


# ---------------------------------------------------------------- layout
def auto_ivf_geometry(n_live: int, nlist: int = 0,
                      winners: int = 4) -> tuple[int, int]:
    """(nlist, cap) for a corpus of ``n_live`` rows, the reference's rule:
    cap a multiple of 128 with winners * cap / 128 <= 128 (one pool row per
    (cluster, prober)), ~30% slack over the mean fill, a mean fill of ~2048
    rows a cluster, and always room for every row plus one pad a
    cluster."""
    cap_max = (IVF_PW // max(winners, 1)) * LANES
    if nlist <= 0:
        nlist = max(8, -(-n_live // 2048))
    cap = -(-int(n_live / nlist * 1.3) // LANES) * LANES
    cap = min(max(cap, LANES), cap_max)
    while nlist * cap < n_live + nlist:
        nlist += max(1, nlist // 8)
        cap = min(max(-(-int(n_live / nlist * 1.3) // LANES) * LANES,
                      LANES), cap_max)
    return nlist, cap


# ----------------------------------------------------------- device layout
def _segment_rank(key_sorted: torch.Tensor) -> torch.Tensor:
    """Rank of each entry of a sorted key vector within its run of equal
    keys (the reference's searchsorted of the first occurrence)."""
    first = torch.searchsorted(key_sorted, key_sorted, side="left")
    return torch.arange(key_sorted.numel(), device=key_sorted.device) - first


def balanced_layout_dev(choices: torch.Tensor, valid: torch.Tensor,
                        nlist: int, cap: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Place live rows into a dense balanced [nlist, cap] grid on the
    device (the choices never cross to the host): per round, stable-sort
    the still-unplaced rows by their a-th choice, rank them within each
    cluster and fill each cluster up to ``cap`` (first come by slot
    order); rows that exhaust all A choices take the free grid positions in
    order.  Gives the reference's placement exactly for the same choices.

    choices [M, A] per-slot cluster preferences; valid [M] bool.  Returns
    (pos2slot [nlist*cap] int32, -1 at padding; slot2pos [M] int32, -1 at
    invalid slots; spilled count, a 0-d int64 tensor)."""
    m, a_n = choices.shape
    dev = choices.device
    grid = nlist * cap
    placed = torch.full((m,), -1, dtype=torch.int64, device=dev)
    counts = torch.zeros((nlist,), dtype=torch.int64, device=dev)
    for a in range(a_n):
        key = torch.where(valid & (placed < 0), choices[:, a].long(), nlist)
        key_s, order = torch.sort(key, stable=True)
        fill = counts[key_s.clamp(max=nlist - 1)] + _segment_rank(key_s)
        ok = (key_s < nlist) & (fill < cap)
        placed[order] = torch.where(ok, key_s * cap + fill, placed[order])
        counts.scatter_add_(0, key_s.clamp(max=nlist - 1), ok.long())
    # spill: the i-th still-unplaced valid row -> the i-th free position
    un = valid & (placed < 0)
    occ = torch.zeros((grid + 1,), dtype=torch.int32, device=dev)
    occ[torch.where(placed >= 0, placed, grid)] = 1
    free_order = torch.sort(occ[:grid], stable=True).indices
    un_rank = torch.cumsum(un.long(), 0) - 1
    placed = torch.where(un, free_order[un_rank.clamp(0, grid - 1)], placed)
    pos2slot = torch.full((grid + 1,), -1, dtype=torch.int32, device=dev)
    pos2slot[torch.where(placed >= 0, placed, grid)] = torch.arange(
        m, dtype=torch.int32, device=dev)
    return pos2slot[:grid], placed.to(torch.int32), un.sum()


def coarse_choices(src: torch.Tensor, scales, centroids: torch.Tensor,
                   metric: str, a_n: int, chunk: int) -> torch.Tensor:
    """The ``a_n`` nearest centroids of every corpus row [M, a_n] int32,
    ``chunk`` rows a step (the last step may be short), so only a [chunk,
    nlist] score block exists.  ``src`` is the raw [M, d] f32 store, or with
    ``scales`` the int32-packed int8 store (dequantized a chunk at a
    time); rows are normalized under cosine.  An exact top-k where the
    reference takes ``approx_max_k`` past 1024 clusters."""
    m = src.shape[0]
    cn = torch.sum(centroids * centroids, dim=1)
    out = torch.empty((m, a_n), dtype=torch.int32, device=src.device)
    for s in range(0, m, chunk):
        rows = src[s:s + chunk]
        if scales is not None:
            rows = words_to_f32(rows) * scales[s:s + chunk, None]
        if metric == "cosine":
            rows = normalize_rows(rows)
        cd = cn[None, :] - 2.0 * (rows @ centroids.T)
        out[s:s + chunk] = torch.topk(cd, a_n, dim=1, largest=False,
                                      sorted=True).indices.to(torch.int32)
    return out


# -------------------------------------------------------------- inversion
def invert_probers(top_c: torch.Tensor, nlist: int, p_cap: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Invert the per-query probe lists [Q, nprobe] into per-cluster prober
    tiles: (probers [nlist*p_cap] int32 query indices, 0 at empty slots;
    ppos [Q, nprobe] int32, each (query, probe)'s slot in its cluster's
    tile, -1 where the tile overflowed and the probe is dropped).  A stable
    sort by cluster and a segment rank, as in the reference."""
    q_n, nprobe = top_c.shape
    dev = top_c.device
    flat = top_c.reshape(-1).long()
    sorted_c, order = torch.sort(flat, stable=True)
    rank = _segment_rank(sorted_c)
    keep = rank < p_cap
    tgt = torch.where(keep, sorted_c * p_cap + rank, nlist * p_cap)
    probers = torch.zeros((nlist * p_cap + 1,), dtype=torch.int32, device=dev)
    probers[tgt] = (order // nprobe).to(torch.int32)
    ppos = torch.full((q_n * nprobe,), -1, dtype=torch.int32, device=dev)
    ppos[order] = torch.where(keep, rank, -1).to(torch.int32)
    return probers[:nlist * p_cap], ppos.view(q_n, nprobe)


def prober_counts(top_c: torch.Tensor, nlist: int, p_cap: int
                  ) -> torch.Tensor:
    """The prober rows of each cluster's tile [nlist] int32, min(probes of
    the cluster, p_cap); 0 marks a cluster no query probes.  The port's
    stand-in for the reference's ``_unique_worklist``: a scatter-add on the
    device (``torch.bincount`` would read its size back to the host)."""
    flat = top_c.reshape(-1).long()
    counts = torch.zeros((nlist,), dtype=torch.int32, device=top_c.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return counts.clamp_(max=p_cap)


# ----------------------------------------------------------------- search
def ivf_pool_candidates(queries: torch.Tensor, centroids: torch.Tensor,
                        cm_packed: torch.Tensor, off_cm: torch.Tensor,
                        sc_cm: torch.Tensor, cvec: torch.Tensor,
                        pos2slot: torch.Tensor, metric: str, nprobe: int,
                        p_cap: int, pool: int, winners: int = 4
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cluster-pruned candidate stage: probe -> invert -> gather the
    prober queries -> fused cluster scan -> per-query merge.

    queries [Q, d] f32 as the index hands them (the pow2-padded batch, not
    centered; cosine normalizes here); centroids [nlist, d] in probe space;
    cm/off/sc/cvec/pos2slot the cluster-major layout
    (``index/hnsw_pq._ivf_layout``).  The int8 query scale is ONE scale over
    the whole batch, sq = max|q - cvec| / 127, so the zero pad rows (which
    center to -cvec) take part in it, as in the reference.  Returns (vals
    [Q, pool] selection scores ascending, slots [Q, pool] store slots, -1
    where empty)."""
    nlist, d = centroids.shape
    cap = cm_packed.shape[0] // nlist
    q = normalize_rows(queries) if metric == "cosine" else queries
    # probe: rank-equivalent centroid distances, exact select
    cn = torch.sum(centroids * centroids, dim=1)
    cd = cn[None, :] - 2.0 * (q @ centroids.T)
    nprobe = min(nprobe, nlist)
    top_c = torch.topk(cd, nprobe, dim=1, largest=False, sorted=True).indices
    probers, ppos = invert_probers(top_c, nlist, p_cap)
    # quantize the batch once (one global scale), pack, gather the tiles
    qc = q - cvec[None, :]
    sq = torch.clamp(torch.amax(torch.abs(qc)), min=1e-12) / 127.0
    q8 = torch.clamp(torch.round(qc / sq), -127, 127).to(torch.int8)
    q8 = torch.nn.functional.pad(q8, (0, 4 * cm_packed.shape[1] - d))
    qsel = q8.view(torch.int32)[probers.long()]          # [nlist*p_cap, d/4]
    vals, pos = fused_ivf_pool(prober_counts(top_c, nlist, p_cap), qsel,
                               cm_packed, off_cm, sc_cm * sq, nlist, cap,
                               p_cap, winners, probes=top_c.numel())
    # per-query merge: each (query, probe)'s pool row, dropped probes masked
    rows = (top_c * p_cap + ppos).clamp(min=0)            # [Q, nprobe]
    live = (ppos >= 0)[:, :, None]
    vals_g = torch.where(live, vals[rows], float("inf")).reshape(q.shape[0], -1)
    pos_g = torch.where(live, pos[rows], -1).reshape(q.shape[0], -1)
    pool = min(pool, vals_g.shape[1])
    best, sel = torch.topk(vals_g, pool, dim=1, largest=False, sorted=True)
    cand = torch.gather(pos_g, 1, sel)
    ok = torch.isfinite(best) & (cand >= 0)
    slots = torch.where(ok, pos2slot[cand.clamp(min=0).long()], -1)
    return best, slots
