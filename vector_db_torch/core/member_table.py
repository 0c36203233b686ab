"""Quota + overflow cluster-member tables (a numpy copy of
``vector_db_tpu/core/member_table.py``; host code, no device work).

HnswPqIndex's coarse quantizer keeps cluster membership as a padded
``[nlist, L]`` slot table so probing is one gather.  Padding to the largest
cluster explodes the per-query candidate gather when k-means yields one huge
cluster, and truncating loses recall on skewed corpora.  So each cluster
keeps at most a quota of members, and members past the quota spill into a
shared overflow list that every query scans: bounded candidate width, no
recall cliff.  The table is made by numpy argsort bucketing, O(P log P) in
the number of (slot, cluster) pairs.
"""

from __future__ import annotations

import numpy as np


def build_member_table(
    assignments: np.ndarray,
    valid: np.ndarray,
    num_clusters: int,
    quota_mult: float = 4.0,
    align: int = 32,
) -> tuple[np.ndarray, int, np.ndarray]:
    """Build a quota-capped member table + overflow list, fully vectorized.

    Args:
      assignments: ``[cap]`` or ``[cap, A]`` int cluster ids per slot
        (-1 = unassigned; multi-assignment spills one slot into A clusters).
      valid: ``[cap]`` bool live mask.
      num_clusters: number of clusters C.
      quota_mult: per-cluster quota = quota_mult x mean cluster size
        (rounded up to ``align``).
      align: pad/round granularity (a bounded set of table shapes).

    Returns ``(table [C, L] int32 -1-padded, L, overflow int32 -1-padded)``.
    Overflow holds each quota-spilled slot once (deduplicated): queries scan
    it unconditionally, so one entry suffices regardless of how many clusters
    a slot spilled from.
    """
    a = np.asarray(assignments)
    if a.ndim == 1:
        a = a[:, None]
    cap, width = a.shape
    v = np.asarray(valid, bool)
    # flatten (slot, cluster) pairs, keep live + assigned; int32 throughout
    # and no filter pass on the common all-live path (this runs after every
    # mutation burst)
    cls = np.ascontiguousarray(a.reshape(-1), dtype=np.int32)
    slots = np.repeat(np.arange(cap, dtype=np.int32), width)
    keep = cls >= 0
    if not v.all():
        keep &= np.repeat(v, width)
    if not keep.all():
        slots, cls = slots[keep], cls[keep]
    c = max(1, int(num_clusters))
    if slots.size == 0:
        return (np.full((c, align), -1, np.int32), align,
                np.full(align, -1, np.int32))
    # stable bucket sort by cluster: ranks-within-cluster come from the
    # position offset against each cluster's start
    order = np.argsort(cls, kind="stable")
    cls_s, slots_s = cls[order], slots[order]
    counts = np.bincount(cls_s, minlength=c)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    ranks = np.arange(cls_s.size, dtype=np.int64) - starts[cls_s]
    quota = max(align, int(np.ceil(quota_mult * cls_s.size / c / align)) * align)
    in_quota = ranks < quota
    max_len = int(min(quota, counts.max() if counts.size else 1))
    max_len = max(align, ((max_len + align - 1) // align) * align)
    table = np.full((c, max_len), -1, np.int32)
    table[cls_s[in_quota], ranks[in_quota]] = slots_s[in_quota].astype(np.int32)
    over = np.unique(slots_s[~in_quota]).astype(np.int32)
    if over.size == 0:
        over = np.full(align, -1, np.int32)
    pad = (-over.size) % align
    if pad:
        over = np.concatenate([over, np.full(pad, -1, np.int32)])
    return table, max_len, over
