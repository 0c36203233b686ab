"""The plain reference of the cluster-pruned search: what ``scan_ivf`` on
the raw store states it answers, in plain PyTorch, TF32 off, in float64.

For each query:

  1. the ``nprobe`` coarse centroids nearest by squared L2, taken in
     float64;
  2. every live row that the layout places in those clusters, scored by
     the int8 shadow's distance: off[n] + sc[n] * ((q - cvec) . x8[n]),
     where the shadow holds each row as int8 values x8[n] with its scale
     sc[n] (-2 x the row's quantization step under L2), its offset off[n]
     (||x[n] - cvec||^2) and the corpus centering cvec, so that the score
     is ||x[n] - q||^2 - ||q - cvec||^2 with x[n] - cvec rounded to int8;
  3. the ``winners`` best of each 128-row bucket of each probed cluster
     (a bucket is 128 consecutive positions of the layout's grid);
  4. the ``pool`` best of those;
  5. those, and every live row of the overlay (rows written since the
     layout, which the program scores exactly beside the pool), ranked by
     their float64 squared L2 to the float32 rows;
  6. the k nearest, ascending, as euclidean distances.

It works from the index's trained state as plain tensors (the coarse
centroids [nlist, d]; the grid position of each store slot [N], -1 where
the layout holds none, and the rows per cluster ``cap``; the overlay's
slots; the int8 shadow's rows, offsets, scales and centering; the f32 rows
[N, d]; the live mask [N]), which a test reads from the index, and imports
nothing of the program.  It loops over the probed clusters as the program's
cluster scan does, so that it scores only the probed rows and runs at
1,000,000 x 128 on the card; queries go in blocks.

Where it departs from the program's route, each a rounding or a limit that
the search's options do not state:

  * the query is not quantized: the program rounds the batch (padded with
    zero rows to a power of two) to int8 with one scale, max|q - cvec| /
    127 over the padded batch, and scores f32(q8 . x8) * sc * scale; the
    reference takes the centered query in float64;
  * the probe ranks the centroids by float64 distances, the program by
    ||c||^2 - 2 q.c in float32: a centroid tied at the nprobe-th place
    within that rounding may be probed by one and not the other;
  * no probe is dropped: the program drops a (query, cluster) pair past the
    cluster's prober tile (p_cap queries a cluster in one batch);
  * the selects rank float64 scores with ``torch.topk``, the program's
    kernel float32 ones, first index first on ties;
  * the metric is L2 alone; the program also serves cosine, on normalized
    rows.
"""

from __future__ import annotations

import torch

from .reference import tf32_off

#: rows of a bucket, the unit the winners are kept from
BUCKET = 128
#: queries a block holds ([Q_BLOCK, nlist, d] float64 differences at the
#: probe: 128 MB at 256 x 489 x 128)
Q_BLOCK = 256


def probe(queries: torch.Tensor, centroids: torch.Tensor, nprobe: int
          ) -> torch.Tensor:
    """The ``nprobe`` nearest centroids of each query [Q, nprobe] int64,
    by float64 squared L2."""
    c = centroids.to(torch.float64)
    d2 = (queries.to(torch.float64)[:, None, :] - c[None]).square().sum(2)
    return torch.topk(d2, min(nprobe, c.shape[0]), dim=1, largest=False,
                      sorted=True).indices


def grid_slots(slot2pos: torch.Tensor, valid: torch.Tensor, grid: int
               ) -> torch.Tensor:
    """The store slot at each grid position [grid] int64, -1 where the
    position holds no live row."""
    out = torch.full((grid,), -1, dtype=torch.int64, device=slot2pos.device)
    slots = torch.nonzero((slot2pos >= 0) & valid).flatten()
    out[slot2pos[slots].long()] = slots
    return out


def pool_candidates(queries: torch.Tensor, centroids: torch.Tensor,
                    pos_slot: torch.Tensor, cap: int, base8: torch.Tensor,
                    off: torch.Tensor, sc: torch.Tensor, cvec: torch.Tensor,
                    nprobe: int, winners: int, pool: int) -> torch.Tensor:
    """Steps 1-4 for one block of queries: the pool's store slots [Q,
    pool'] int64 (pool' = min(pool, the bucket winners a query can have)),
    -1 where fewer rows scored."""
    q_n, d = queries.shape
    dev = queries.device
    top_c = probe(queries, centroids, nprobe)                 # [Q, P]
    nprobe = top_c.shape[1]
    per_probe = (cap // BUCKET) * winners
    vals = torch.full((q_n, nprobe, per_probe), float("inf"),
                      dtype=torch.float64, device=dev)
    slots = torch.full((q_n, nprobe, per_probe), -1, dtype=torch.int64,
                       device=dev)
    qc = queries.to(torch.float64) - cvec.to(torch.float64)[None, :]
    flat = top_c.reshape(-1)
    clusters, order = torch.sort(flat, stable=True)
    counts = torch.bincount(clusters).tolist()
    start = 0
    for c, m in enumerate(counts):
        if not m:
            continue
        pairs = order[start:start + m]
        start += m
        qi, pj = pairs // nprobe, pairs % nprobe
        lo = c * cap
        g = pos_slot[lo:lo + cap]                              # [cap]
        live = g >= 0
        gs = g.clamp(min=0)
        x8 = base8[gs, :d].to(torch.float64)                   # [cap, d]
        score = off[gs].to(torch.float64)[None, :] \
            + sc[gs].to(torch.float64)[None, :] * (qc[qi] @ x8.T)
        score = torch.where(live[None, :], score, float("inf"))
        v, a = torch.topk(score.view(m, cap // BUCKET, BUCKET), winners,
                          dim=2, largest=False, sorted=True)
        pos = a + torch.arange(0, cap, BUCKET, device=dev)[None, :, None]
        vals[qi, pj] = v.reshape(m, -1)
        slots[qi, pj] = g[pos].reshape(m, -1)
    vals, slots = vals.reshape(q_n, -1), slots.reshape(q_n, -1)
    best, sel = torch.topk(vals, min(pool, vals.shape[1]), dim=1,
                           largest=False, sorted=True)
    return torch.where(torch.isfinite(best), torch.gather(slots, 1, sel), -1)


def rerank_f64(queries: torch.Tensor, rows: torch.Tensor,
               cand: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(row slots [Q, k] int64, euclidean distances [Q, k] float64) of the
    k candidates (-1 ignored) nearest to each query by float64 squared L2
    to the float32 rows; ascending."""
    q = queries.to(torch.float64)
    v = rows[cand.clamp(min=0)].to(torch.float64)
    d2 = (v - q[:, None, :]).square().sum(2)
    d2 = torch.where(cand >= 0, d2, float("inf"))
    d2, sel = torch.sort(d2, dim=1)
    ids = torch.gather(cand, 1, sel[:, :k])
    return torch.where(torch.isfinite(d2[:, :k]), ids, -1), d2[:, :k].sqrt()


def search(queries: torch.Tensor, centroids: torch.Tensor,
           slot2pos: torch.Tensor, cap: int, overlay: torch.Tensor,
           base8: torch.Tensor, off: torch.Tensor, sc: torch.Tensor,
           cvec: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor,
           k: int, nprobe: int, winners: int, pool: int
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(row slots [Q, k] int64, euclidean distances [Q, k] float64, the
    pool's slots [Q, pool']) of the cluster-pruned search (see the
    module).  ``overlay`` [m] int64 store slots (dead ones ignored)."""
    dev = rows.device
    pos_slot = grid_slots(slot2pos, valid, centroids.shape[0] * cap)
    overlay = overlay.to(device=dev, dtype=torch.int64)
    overlay = overlay[valid[overlay]] if overlay.numel() else overlay
    out_i, out_d, out_p = [], [], []
    with tf32_off():
        for qa in range(0, queries.shape[0], Q_BLOCK):
            q = queries[qa:qa + Q_BLOCK].to(torch.float32)
            cand = pool_candidates(q, centroids, pos_slot, cap, base8, off,
                                   sc, cvec, nprobe, winners, pool)
            full = torch.cat([cand, overlay[None, :].expand(
                q.shape[0], -1)], 1)
            ids, dists = rerank_f64(q, rows, full, k)
            out_i.append(ids)
            out_d.append(dists)
            out_p.append(cand)
    return torch.cat(out_i), torch.cat(out_d), torch.cat(out_p)
