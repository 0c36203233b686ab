"""Compression and index configuration.

A copy of ``vector_db_tpu/api/config.py``: the same dataclasses, fields and
defaults, so a configuration means the same thing to both packages.  The
field comments of the reference record why each default was chosen there;
they are shortened here.  Copied rather than imported because importing the
reference package loads JAX.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class CompressionType(enum.Enum):
    NONE = "none"
    PQ = "pq"
    HNSWPQ = "hnswpq"


@dataclasses.dataclass
class CompressionConfig:
    """Product-quantization compression settings.

    compression ratio = 4 * dim / num_subspaces: each float32 subvector of
    dim/num_subspaces floats becomes one uint8 code.
    """

    enabled: bool = False
    compression_type: CompressionType = CompressionType.NONE
    num_subspaces: int = 8
    num_centroids: int = 256
    training_iterations: int = 25

    @classmethod
    def default_config(cls) -> "CompressionConfig":
        return cls()

    @classmethod
    def pq_config(cls, num_subspaces: int = 8) -> "CompressionConfig":
        return cls(True, CompressionType.PQ, num_subspaces)

    @classmethod
    def hnsw_pq_config(cls, num_subspaces: int = 8) -> "CompressionConfig":
        return cls(True, CompressionType.HNSWPQ, num_subspaces)

    @classmethod
    def recommended_config(cls, dimension: int) -> "CompressionConfig":
        """dim/8 subspaces -> 32x at 512-dim."""
        return cls(True, CompressionType.HNSWPQ, max(1, dimension // 8))

    @classmethod
    def high_recall_config(cls, dimension: int) -> "CompressionConfig":
        """dim/4 subspaces -> 16x."""
        return cls(True, CompressionType.HNSWPQ, max(1, dimension // 4))

    @classmethod
    def high_compression_config(cls, dimension: int) -> "CompressionConfig":
        """dim/16 subspaces -> 64x."""
        return cls(True, CompressionType.HNSWPQ, max(1, dimension // 16))

    def compression_ratio(self, dimension: int) -> float:
        if not self.enabled or self.num_subspaces <= 0:
            return 1.0
        return 4.0 * dimension / self.num_subspaces

    def memory_savings_pct(self, dimension: int) -> float:
        r = self.compression_ratio(dimension)
        return (1.0 - 1.0 / r) * 100.0 if r > 0 else 0.0

    def effective_subspaces(self, dimension: int) -> int:
        """Largest subspace count <= num_subspaces that divides dimension."""
        sub = min(self.num_subspaces, dimension)
        for cand in range(sub, 0, -1):
            if dimension % cand == 0:
                return cand
        return 1


@dataclasses.dataclass
class HnswConfig:
    """HNSW graph index settings (``index/hnsw.py``).

    ``ef_search`` 0 is the adaptive beam of :meth:`ef_for_query`; ``max_level``
    0 derives the level count from the capacity; ``heuristic`` False selects
    plain nearest-M neighbors; ``bulk_build`` builds from scratch by exact
    k-NN construction; ``insert_policy`` "defer" buffers adds (searches see
    them through an exact overlay) and connects them in bulk once the buffer
    reaches max(flush_min, min(flush_frac * graph rows, flush_max)), "stream"
    inserts the moment ``add_batch`` returns.
    """

    m: int = 32
    ef_construction: int = 400
    ef_search: int = 0
    ef_delta: int = 32
    max_level: int = 0
    expand_per_iter: int = 4
    batch_insert: int = 64
    heuristic: bool = True
    bulk_build: bool = True
    insert_policy: str = "defer"
    flush_min: int = 1024
    flush_frac: float = 0.25
    flush_max: int = 32768
    flush_chunk: int = 0

    def derived_max_level(self, capacity: int) -> int:
        if self.max_level > 0:
            return self.max_level
        return max(1, int(math.log(max(capacity, 2))
                          / math.log(max(self.m, 2))) + 1)

    def ef_for_query(self, k: int, n: int = 1000, dim: int = 0) -> int:
        """Per-query beam width (the reference's policy, value for value).

        Fixed mode (``ef_search > 0``): max(ef_search, 4k).  Adaptive mode:
        (k + ef_delta) grows ~20% a decade of N, the k-multiplier floor
        steps 4/5/6/8 at 1k/5k/20k rows, capped at 300 (<= 10k rows) / 400;
        at dim >= 256 a floor of 256..320 (+64 past 20k rows; 768 there at
        dim >= 384, 512 below) widens the beam where greedy descent loses
        discrimination, and the cap lifts to 1024 past 10k rows.
        """
        if self.ef_search > 0:
            return max(self.ef_search, 4 * k)
        base = k + self.ef_delta
        if n > 100:
            base = int(base * (1.0 + 0.2 * math.log10(n / 100.0 + 1.0)))
        mult = 4
        if n > 1000:
            mult = 5
        if n > 5000:
            mult = 6
        if n > 20000:
            mult = 8
        ef = max(base, k * mult)
        floor = 0
        if dim >= 256 and n > 1000:
            floor = 256 + 32 * min(max((dim - 128) // 256, 0), 2)
            if n > 20000:
                floor += 64
        cap = 300 if n <= 10000 else 400
        if dim >= 256:
            cap = 1024 if n > 10000 else cap
            if n > 20000:
                floor = max(floor, 768 if dim >= 384 else 512)
        # never clip an adaptive beam under the fixed mode's floor
        cap = max(cap, 4 * k)
        return min(max(ef, floor), max(cap, floor))


@dataclasses.dataclass
class HnswPqConfig:
    """Flagship HNSW+PQ settings (same fields and defaults as the reference).

    Both stores (``raw_store``; the compressed one with
    ``refine_residual``) and every search mode of the reference: ``auto``,
    ``scan_exact``, ``scan_pallas_int8`` (``int8_epilogue`` ``per_row`` or
    ``global``), ``scan_pallas``, ``scan_bf16``, ``adc_fast`` (pools
    ``bucket``, ``approx`` and ``fused``), ``scan_int8``, ``scan_ivf`` (the
    coarse quantizer: ``nlist``, 0 auto-sizes it under scan_ivf; ``nprobe``;
    ``ivf_p_cap``, ``ivf_winners``, ``ivf_pool``, 0 = the reference's
    rules), ``adc`` (the table scan, cluster-pruned with ``nlist > 0``;
    ``refine_k`` candidates re-ranked), ``pca`` (``proxy_dims``, ``pca_r``)
    and, with ``use_graph=True`` (raw store only), ``graph``: ADC-distance
    traversal (``m``, ``ef_construction``, ``ef_search``) with an exact
    re-rank, adds deferred as in :class:`HnswConfig`.
    """

    m: int = 32
    ef_construction: int = 64
    ef_search: int = 64
    num_subspaces: int = 64
    num_centroids: int = 256
    training_iterations: int = 25
    training_samples: int = 10000  # lazy-train threshold and sample cap
    refine_k: int = 1024
    use_graph: bool = False  # True builds the graph; auto then searches it
    insert_policy: str = "defer"
    flush_min: int = 1024
    flush_frac: float = 0.25
    flush_max: int = 32768
    flush_chunk: int = 0
    nlist: int = 0
    nprobe: int = 32
    ivf_p_cap: int = 0
    ivf_winners: int = 4
    ivf_pool: int = 0
    # auto: scan_exact below 700k live rows, scan_pallas_int8 at and above
    # (the reference's crossover, kept until an H100 sweep sets the port's:
    # ROADMAP A8)
    search_mode: str = "auto"
    scan_recall_target: float = 0.99  # the port's scans select exactly
    int8_epilogue: str = "per_row"  # "global": the int32-epilogue pool (B7)
    adc_bucket: int = 32
    adc_winners: int = 1
    adc_pool: str = "bucket"
    balance_dims: bool = True  # variance-balanced PQ dimension permutation
    refine_store: str = "f32"
    raw_store: bool = True  # False -> the compressed int8 tier
    refine_residual: bool = False
    adc_select_r: int = 0
    proxy_dims: int = 32
    pca_r: int = 256


@dataclasses.dataclass
class PqConfig:
    num_subspaces: int = 8
    num_centroids: int = 256
    training_iterations: int = 10
    refine_k: int = 0
    balance_dims: bool = True


@dataclasses.dataclass
class IvfConfig:
    num_clusters: int = 100
    num_probes: int = 10
    training_iterations: int = 25
    multi_assign: int = 8


@dataclasses.dataclass
class LshConfig:
    num_tables: int = 0
    num_bits: int = 0
    hamming_radius: int = -1
    bucket_width: float = 0.0
    backfill: bool = True


@dataclasses.dataclass
class AnnoyConfig:
    num_trees: int = 12
    leaf_size: int = 16
    search_k: int = 0
    backfill: bool = True
