"""The plain reference: the exact k nearest rows by squared L2, in plain
PyTorch with TF32 off, and its control in the precision just below.

It works from the rows and queries the harness drew (``data.py``) and
imports nothing of the program.  ``exact_topk`` selects candidates by the
expansion |q|^2 + |x|^2 - 2 q.x in float32 (TF32 off), ``margin`` more than
asked, and ranks them by distances taken again in float64, so its top k is
exact unless two rows lie within float32 rounding of the k-th distance.

``LowerPrecisionSearch`` is the control: the same search put in the
program's place, with the cross term in TF32 (the precision just below
float32 with TF32 off), answering as the facade does.  The comparison must
find it wrong.  TF32 is applied by rounding both operands to its 10-bit
mantissa and multiplying them in float32, as the tensor cores do, on every
device: a product with one query row runs on cuBLAS's matrix-vector kernels,
which ignore ``allow_tf32``, so the flag alone left the single-query control
in full float32.
"""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch

#: queries and rows a block of the reference's search holds
Q_BLOCK = 2048
R_BLOCK = 1 << 17
#: extra candidates ranked again in float64
MARGIN = 8

Result = collections.namedtuple("Result", "id distance")


@contextlib.contextmanager
def tf32_off():
    """Matrix products in full float32, whatever the process has set."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    away from zero; finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _cross(q: torch.Tensor, rows: torch.Tensor, precision: str):
    if precision == "tf32":
        q, rows = round_tf32(q), round_tf32(rows)
    elif precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    with tf32_off():
        return q @ rows.T


def row_norms(rows: torch.Tensor) -> torch.Tensor:
    """|x|^2 of every row, float32, in blocks."""
    return torch.cat([rows[a:a + R_BLOCK].square().sum(1)
                      for a in range(0, rows.shape[0], R_BLOCK)])


def topk_sq_l2(queries: torch.Tensor, rows: torch.Tensor, k: int,
               precision: str = "f32", norms: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(squared distances [Q, k] f32 ascending, row ids [Q, k] int64) of
    the k nearest rows by the expansion, the cross term in ``precision``."""
    if norms is None:
        norms = row_norms(rows)
    out_d, out_i = [], []
    for qa in range(0, queries.shape[0], Q_BLOCK):
        q = queries[qa:qa + Q_BLOCK]
        qn = q.square().sum(1)
        best_d = torch.full((q.shape[0], 0), float("inf"), device=q.device)
        best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64,
                             device=q.device)
        for ra in range(0, rows.shape[0], R_BLOCK):
            blk = rows[ra:ra + R_BLOCK]
            d = qn[:, None] + norms[None, ra:ra + blk.shape[0]] \
                - 2.0 * _cross(q, blk, precision)
            kk = min(k, d.shape[1])
            bd, bi = torch.topk(d, kk, dim=1, largest=False)
            best_d = torch.cat([best_d, bd], 1)
            best_i = torch.cat([best_i, bi + ra], 1)
            kk = min(k, best_d.shape[1])
            best_d, sel = torch.topk(best_d, kk, dim=1, largest=False)
            best_i = torch.gather(best_i, 1, sel)
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)


def sq_dists_f64(queries: torch.Tensor, rows: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """Squared L2 from each query to the rows ``ids`` [Q, m] (int64, -1
    where none) in float64: [Q, m], NaN where the id is -1."""
    out = []
    qb = max(1, Q_BLOCK // 4)
    for qa in range(0, queries.shape[0], qb):
        q = queries[qa:qa + qb].to(torch.float64)
        i = ids[qa:qa + qb]
        v = rows[i.clamp(min=0)].to(torch.float64)            # [qb, m, d]
        d2 = (v - q[:, None, :]).square().sum(2)
        out.append(torch.where(i >= 0, d2, torch.full_like(d2, float("nan"))))
    return torch.cat(out)


def exact_topk(queries: torch.Tensor, rows: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(row ids [Q, k] int64, squared distances [Q, k] f64) of the exact k
    nearest rows, ranked in float64."""
    _, cand = topk_sq_l2(queries, rows, k + MARGIN, "f32")
    d2 = sq_dists_f64(queries, rows, cand)
    d2, sel = torch.sort(d2, dim=1)
    return torch.gather(cand, 1, sel)[:, :k], d2[:, :k]


class LowerPrecisionSearch:
    """The control: the reference in the program's place, answering
    ``search_batch`` and ``search`` as the facade does (ascending
    (id, euclidean distance) results; row i has id i), its cross term in
    TF32."""

    def __init__(self, rows: torch.Tensor):
        self.rows = rows
        self.norms = row_norms(rows)

    def search_batch(self, queries, k: int) -> list[list[Result]]:
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(
            self.rows.device)
        d2, ids = topk_sq_l2(q, self.rows, k, "tf32", self.norms)
        dist = d2.clamp(min=0).sqrt().cpu().numpy().tolist()
        ids = ids.cpu().numpy().tolist()
        return [[Result(i, d) for i, d in zip(ri, rd)]
                for ri, rd in zip(ids, dist)]

    def search(self, query, k: int) -> list[Result]:
        return self.search_batch(np.asarray(query, np.float32)[None, :], k)[0]

    def metrics(self) -> dict:
        return {"counts": {}, "seconds": {}}
