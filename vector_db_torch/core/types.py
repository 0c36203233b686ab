"""Core value types: Vector and SearchResult (a copy of
``vector_db_tpu/core/types.py``; host-side numpy values)."""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


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


def make_results(
    ids: Sequence[int], sq_dists: Sequence[float], metric: str = "l2"
) -> list[SearchResult]:
    """(slot-id, squared-distance) rows -> SearchResults; -1 ids and
    non-finite distances are dropped, L2 is reported as euclidean."""
    out: list[SearchResult] = []
    for i, d in zip(ids, sq_dists):
        if i < 0 or not math.isfinite(d):
            continue
        dist = math.sqrt(max(float(d), 0.0)) if metric == "l2" else float(d)
        out.append(SearchResult(int(i), dist))
    return out
