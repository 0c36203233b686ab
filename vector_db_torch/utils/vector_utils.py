"""Static vector math utilities: a copy of
``vector_db_tpu/utils/vector_utils.py`` (host numpy, no device work; copied
rather than imported because the reference package loads JAX)."""

from __future__ import annotations

import numpy as np


def euclidean_distance(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    _check(a, b)
    d = a - b
    return float(np.sqrt(np.dot(d, d)))


def squared_euclidean_distance(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    _check(a, b)
    d = a - b
    return float(np.dot(d, d))


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    _check(a, b)
    denom = float(np.linalg.norm(a) * np.linalg.norm(b))
    if denom == 0.0:
        return 0.0
    return float(np.dot(a, b) / denom)


def normalize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.float32)
    n = float(np.linalg.norm(v))
    if n == 0.0:
        return v.copy()
    return v / n


def norm(v: np.ndarray) -> float:
    return float(np.linalg.norm(np.asarray(v, np.float32)))


def quantize(v: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Scalar byte quantization (reference: VectorUtils.java:70-86):
    maps [min, max] linearly onto uint8.  Returns (bytes, min, scale)."""
    v = np.asarray(v, np.float32)
    lo = float(v.min()) if v.size else 0.0
    hi = float(v.max()) if v.size else 0.0
    scale = (hi - lo) / 255.0 if hi > lo else 1.0
    q = np.round((v - lo) / scale).astype(np.uint8)
    return q, lo, scale


def dequantize(q: np.ndarray, lo: float, scale: float) -> np.ndarray:
    """Inverse of :func:`quantize` (reference: VectorUtils.java:88-97)."""
    return np.asarray(q, np.float32) * scale + lo


def _check(a: np.ndarray, b: np.ndarray) -> None:
    if a.shape != b.shape:
        raise ValueError(f"dimension mismatch: {a.shape} vs {b.shape}")
