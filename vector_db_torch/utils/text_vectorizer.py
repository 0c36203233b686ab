"""Deterministic text -> vector embedding stub: a copy of
``vector_db_tpu/utils/text_vectorizer.py`` (host numpy; copied rather than
imported because the reference package loads JAX).

Functional parity with the reference's TextVectorizer (reference:
util/TextVectorizer.java:23-111): character-level feature extraction with a
fixed seed so similar texts produce similar vectors — per-character gaussian
streams spread over a character-dependent dimension range, pairwise
character-relation features, whole-text features, and leave-one-out partial
hashes so single-character edits stay close.  Not bit-identical to the Java
RNG, but the same construction and the same similarity behaviour.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _stable_hash(text: str) -> int:
    return int.from_bytes(hashlib.sha1(text.encode("utf-8")).digest()[:8], "big")


def text_to_vector(text: str, dimension: int) -> np.ndarray:
    """Embed text into a normalized float32 vector
    (reference: TextVectorizer.textToVector :23-111)."""
    if not text:
        raise ValueError("text must be non-empty")
    vec = np.zeros(dimension, np.float32)
    chars = list(text)
    n = len(chars)

    for i, c in enumerate(chars):
        cv = ord(c)
        char_rng = np.random.default_rng(cv * 31 + i)
        base = (cv * (i + 1)) % dimension
        weight = max(0.3, 1.0 - 0.1 * i)
        span = max(1, dimension // n)
        pos = (base + np.arange(span)) % dimension
        np.add.at(vec, pos, weight * char_rng.standard_normal(span).astype(np.float32))
        # pairwise character relations (reference :64-80)
        for j, c2 in enumerate(chars):
            if i == j:
                continue
            rel = cv * 31 + ord(c2)
            rel_pos = abs(rel) % dimension
            vec[rel_pos] += 0.5 / (1 + abs(i - j))

    # whole-text features (reference :83-90)
    text_rng = np.random.default_rng(_stable_hash(text) % (2**63))
    for _ in range(dimension // 5):
        pos = int(text_rng.integers(0, dimension))
        vec[pos] += 0.3 * float(text_rng.standard_normal())

    # leave-one-out features: single-char edits stay close (reference :92-105)
    if n > 1:
        for i in range(n):
            partial = text[:i] + text[i + 1 :]
            vec[_stable_hash(partial) % dimension] += 0.8

    nrm = float(np.linalg.norm(vec))
    if nrm > 0:
        vec /= nrm
    return vec


def generate_similar_vector(vec: np.ndarray, noise: float = 0.1, seed: int = 42) -> np.ndarray:
    """Mix gaussian noise into a vector, renormalized
    (reference: TextVectorizer.generateSimilarVector :129-156)."""
    vec = np.asarray(vec, np.float32)
    rng = np.random.default_rng(seed)
    # scale so ||perturbation|| ~= noise * ||vec|| regardless of dimension
    pert = rng.standard_normal(vec.shape).astype(np.float32) / np.sqrt(vec.size)
    out = vec + noise * float(np.linalg.norm(vec)) * pert
    nrm = float(np.linalg.norm(out))
    return out / nrm if nrm > 0 else out


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    """reference: TextVectorizer.java:165-186"""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    denom = float(np.linalg.norm(a) * np.linalg.norm(b))
    if denom == 0.0:
        return 0.0
    return float(np.dot(a, b) / denom)
