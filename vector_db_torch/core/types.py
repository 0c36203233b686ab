"""Core value types: Vector and SearchResult (a copy of
``vector_db_tpu/core/types.py``; host-side numpy values)."""

from __future__ import annotations

import ctypes
import dataclasses
import math
import sysconfig
from typing import Sequence

import numpy as np

from ..ops.kernels import _Library, host_cc
from ..utils.stats import GLOBAL


@dataclasses.dataclass(frozen=True)
class Vector:
    """Immutable (id, float32 values) pair."""

    id: int
    values: np.ndarray

    def __post_init__(self):
        object.__setattr__(
            self, "values", np.asarray(self.values, dtype=np.float32)
        )

    @property
    def dimension(self) -> int:
        return int(self.values.shape[0])

    def euclidean_distance(self, other: "Vector") -> float:
        self._check_dim(other)
        diff = self.values - other.values
        return float(math.sqrt(float(np.dot(diff, diff))))

    def cosine_similarity(self, other: "Vector") -> float:
        self._check_dim(other)
        denom = float(np.linalg.norm(self.values) * np.linalg.norm(other.values))
        if denom == 0.0:
            return 0.0
        return float(np.dot(self.values, other.values) / denom)

    def norm(self) -> float:
        return float(np.linalg.norm(self.values))

    def normalize(self) -> "Vector":
        n = self.norm()
        if n == 0.0:
            return Vector(self.id, self.values.copy())
        return Vector(self.id, self.values / n)

    def _check_dim(self, other: "Vector") -> None:
        if self.dimension != other.dimension:
            raise ValueError(
                f"dimension mismatch: {self.dimension} vs {other.dimension}"
            )


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """(id, distance, similarity); similarity = 1 / (1 + 0.5 * distance)
    rounded to 4 decimals; ordering is by distance."""

    id: int
    distance: float
    similarity: float = dataclasses.field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        if self.similarity is None:
            sim = 1.0 / (1.0 + 0.5 * self.distance)
            object.__setattr__(self, "similarity", round(sim, 4))

    def __lt__(self, other: "SearchResult") -> bool:
        return self.distance < other.distance


#: ``rint(sim * 1e4) / 1e4`` is ``round(sim, 4)`` wherever ``sim * 1e4``
#: lies farther than ``1e-6`` from a half: the float64 product is off the
#: exact one by half an ulp at most, under ``2**-24`` below ``_EXACT_BELOW``.
_HALF_BAND = 0.5 - 1e-6
_EXACT_BELOW = 1e9
#: answers a call from which the arithmetic runs in bulk and the objects are
#: built in C: below it numpy's fixed cost (some twenty array operations)
#: outweighs Python's arithmetic answer by answer (a single query's 10
#: answers in bulk made its call's p95 0.07-0.14 ms slower on an H100
#: machine's host), and the C builder's arrays outweigh the Python loop
#: (10 answers: 12 us in the loop, 21 us through the builder there)
BULK_FROM = 32


def _finish_each(ids: np.ndarray, sq_dists: np.ndarray, metric: str):
    """A small call's answers: ``SearchResult.__post_init__``'s arithmetic
    answer by answer.  Returns (rows of (id, distance, similarity), answers, the
    similarities ``round`` took)."""
    rows = []
    for q_ids, q_sq in zip(ids.tolist(), np.asarray(sq_dists).tolist()):
        row = []
        for i, d in zip(q_ids, q_sq):
            if i < 0 or not math.isfinite(d):
                continue
            dist = math.sqrt(max(d, 0.0)) if metric == "l2" else d
            row.append((i, dist, round(1.0 / (1.0 + 0.5 * dist), 4)))
        rows.append(row)
    answers = sum(map(len, rows))
    return rows, answers, answers


def _finish_bulk(ids: np.ndarray, sq_dists: np.ndarray, metric: str):
    """A call's answers with the arithmetic over the whole arrays in
    float64: the same IEEE operations as :func:`_finish_each`, the rounding by
    ``rint`` away from a half and by ``round`` near one (or where huge, or
    not finite).  Returns ((ids int64, distances, similarities, the kept
    entries or None where every entry is kept), answers, the similarities
    ``round`` took); the arrays are [Q, k] and C-contiguous."""
    if not np.can_cast(ids.dtype, np.int64):
        raise TypeError(f"ids must be integers within int64, not {ids.dtype}")
    sq = np.ascontiguousarray(sq_dists, dtype=np.float64)
    keep = np.isfinite(sq)
    keep &= ids >= 0
    answers = int(np.count_nonzero(keep))
    with np.errstate(all="ignore"):
        dist = np.sqrt(np.where(sq < 0.0, 0.0, sq)) if metric == "l2" else sq
        y = 1.0 / (1.0 + 0.5 * dist)
        y *= 1e4
        sim = np.rint(y)
        y -= sim
        exact = np.abs(y, out=y) < _HALF_BAND
        exact &= np.abs(sim) < _EXACT_BELOW
    sim /= 1e4
    slow = keep > exact
    n_slow = int(np.count_nonzero(slow))
    if n_slow:
        at = np.flatnonzero(slow)
        sim.flat[at] = [round(1.0 / (1.0 + 0.5 * d), 4)
                        for d in dist.flat[at].tolist()]
    arrays = (np.ascontiguousarray(ids, dtype=np.int64), dist, sim,
              keep if answers < keep.size else None)
    return arrays, answers, n_slow


def _load_builder(path) -> ctypes.PyDLL:
    lib = ctypes.PyDLL(str(path))
    lib.vdb_build_results.argtypes = ([ctypes.py_object]
                                      + [ctypes.c_void_p] * 4
                                      + [ctypes.c_ssize_t] * 2)
    lib.vdb_build_results.restype = ctypes.py_object
    return lib


#: ``csrc/results_host.c``, built for this interpreter's C API at first use
BUILDER = _Library(f"vdb_results_host_{sysconfig.get_config_var('SOABI')}",
                   "results_host.c", host_cc, _load_builder)


def build_results(ids: np.ndarray, dist: np.ndarray, sim: np.ndarray,
                  keep) -> list[list[SearchResult]]:
    """One SearchResult list a row of [Q, k] arrays (ids int64, dist and sim
    float64, keep bool or None), built by ``csrc/results_host.c``: entry
    (q, c) where ``keep`` holds, with its fields as given."""
    shape = ids.shape
    arrays = [(ids, np.int64), (dist, np.float64), (sim, np.float64)]
    if keep is not None:
        arrays.append((keep, np.bool_))
    for a, dtype in arrays:
        if (len(shape) != 2 or a.dtype != dtype or a.shape != shape
                or not a.flags.c_contiguous):
            raise ValueError(
                f"build_results: {a.dtype}{list(a.shape)} is not a "
                f"C-contiguous {np.dtype(dtype)}[Q, k] like the ids "
                f"{ids.dtype}{list(shape)}")
    return BUILDER.get().vdb_build_results(
        SearchResult, ids.ctypes.data, dist.ctypes.data, sim.ctypes.data,
        None if keep is None else keep.ctypes.data, *shape)


def make_results_batch(
    ids: np.ndarray, sq_dists: np.ndarray, metric: str = "l2"
) -> list[list[SearchResult]]:
    """[Q, k] (id, squared-distance) arrays -> one SearchResult list per
    query, equal field for field to :func:`make_results` on each row.

    From ``BULK_FROM`` answers the arithmetic runs once over the arrays
    (:func:`_finish_bulk`) and the objects are built in C
    (:func:`build_results`); below, both answer by answer in Python, each
    object built without ``__init__``, its three finished fields written
    into its ``__dict__`` in field order.  Bumps ``results.answers``,
    ``results.round_fallback`` (the similarities Python's ``round`` took)
    and ``results.native`` (the answers built in C) once a call."""
    ids = np.asarray(ids)
    if ids.size >= BULK_FROM:
        arrays, answers, n_round = _finish_bulk(ids, sq_dists, metric)
        out = build_results(*arrays)
        GLOBAL.bump("results.native", answers)
    else:
        rows, answers, n_round = _finish_each(ids, sq_dists, metric)
        new = object.__new__
        out = []
        for row_answers in rows:
            row = []
            for i, d, s in row_answers:
                o = new(SearchResult)
                fields = o.__dict__
                fields["id"] = i
                fields["distance"] = d
                fields["similarity"] = s
                row.append(o)
            out.append(row)
    GLOBAL.bump("results.answers", answers)
    GLOBAL.bump("results.round_fallback", n_round)
    return out


def make_results(
    ids: Sequence[int], sq_dists: Sequence[float], metric: str = "l2"
) -> list[SearchResult]:
    """(slot-id, squared-distance) rows -> SearchResults; -1 ids and
    non-finite distances are dropped, L2 is reported as euclidean."""
    return make_results_batch(
        np.asarray(ids, dtype=np.int64).reshape(1, -1),
        np.asarray(sq_dists, dtype=np.float64).reshape(1, -1), metric)[0]
