"""The comparison that decides ``correct``.

The window keeps the answers of the calls its plan marks (``loadgen``),
as arrays of the ids and distances the API returned.  Once the window has closed and the program's
state is freed, they are compared with ``reference.exact_topk`` over the
same rows and queries.  Three numbers, each with its limit:

  * ``missing``: answers with fewer than k results, an id that names no
    row, or an id twice (limit 0: an exact comparison);
  * ``dist_err``: the largest relative gap between a reported distance
    and the euclidean distance from the query to the reported row, taken
    in float64 (limit from ``checks/<workload>.json``, set between the
    program's readings and the control's);
  * ``recall_at_10``: |answer ∩ exact top k| / k, averaged over the
    distinct queries checked, each at its first checked answer (limit from
    ``checks/<workload>.json``, set between the program's least reading and
    the reading of an approximate path or a cut refine: a different
    result, not a faster one, reads under it).

It imports nothing of the program: an answer is read by its ``id`` and
``distance`` attributes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference


def answer_arrays(q_ids, answers, k: int) -> tuple[np.ndarray, np.ndarray,
                                                   np.ndarray]:
    """One call's answers as (pool query index [A], ids [A, k] int64 with
    -1 where short and -2 where longer than k, reported distances [A, k]
    f64 with NaN where short).  The window converts each kept call's
    answers at once, so that it holds no result objects for the collector
    to walk."""
    ids = np.full((len(answers), k), -1, np.int64)
    dist = np.full((len(answers), k), np.nan, np.float64)
    for a, ans in enumerate(answers):
        for j, r in enumerate(ans[:k]):
            ids[a, j] = int(r.id)
            dist[a, j] = float(r.distance)
        if len(ans) > k:          # more than asked: not an answer
            ids[a] = -2
    return np.asarray(q_ids, np.int64), ids, dist


def compare(kept: list, pool: np.ndarray, rows: torch.Tensor, k: int
            ) -> dict:
    """The three numbers over the kept answers (a list of
    :func:`answer_arrays`; see the module)."""
    n = rows.shape[0]
    if not kept:
        return {"missing": 0, "dist_err": float("nan"),
                "recall_at_10": float("nan"), "answers": 0, "queries": 0}
    qidx, ids, dist = (np.concatenate(x) for x in zip(*kept))
    valid = (ids >= 0) & (ids < n)
    dup = np.zeros(ids.shape[0], bool)
    for j in range(1, k):
        dup |= ((ids[:, j:j + 1] == ids[:, :j]) & valid[:, :j]).any(1) \
            & valid[:, j]
    missing = int((~valid.all(1) | dup).sum())

    device = rows.device
    queries = torch.as_tensor(pool[qidx]).to(device)
    safe = torch.as_tensor(np.where(valid, ids, -1)).to(device)
    true_d = reference.sq_dists_f64(queries, rows, safe).clamp(min=0).sqrt()
    true_d = true_d.cpu().numpy()
    with np.errstate(invalid="ignore", divide="ignore"):
        gap = np.abs(dist - true_d) / np.maximum(true_d, 1e-30)
    gap = gap[valid]
    dist_err = float(gap.max()) if gap.size else float("inf")

    first = np.unique(qidx, return_index=True)[1]
    uq = qidx[first]
    ref_ids, _ = reference.exact_topk(torch.as_tensor(pool[uq]).to(device),
                                      rows, k)
    ref_ids = ref_ids.cpu().numpy()
    got = ids[first]
    hits = np.array([np.intersect1d(g[g >= 0], r).size
                     for g, r in zip(got, ref_ids)])
    return {"missing": missing, "dist_err": dist_err,
            "recall_at_10": float(hits.mean() / k),
            "answers": int(qidx.size), "queries": int(uq.size)}


def verdict(numbers: dict, limits: dict) -> dict:
    """Each compared number beside its limit, and whether it holds."""
    out = {
        "missing": {"value": numbers["missing"], "limit": 0,
                    "holds": numbers["missing"] <= 0},
        "dist_err": {"value": numbers["dist_err"],
                     "limit": limits["dist_err"]["limit"],
                     "holds": numbers["dist_err"]
                     <= limits["dist_err"]["limit"]},
        "recall_at_10": {"value": numbers["recall_at_10"],
                         "limit": limits["recall_at_10"]["limit"],
                         "holds": numbers["recall_at_10"]
                         >= limits["recall_at_10"]["limit"]},
    }
    if numbers["answers"] == 0:
        out["missing"]["holds"] = False
    return out
