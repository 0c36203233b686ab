"""LSH index: random-projection hashing with an exact re-rank (the
counterpart of ``vector_db_tpu/index/lsh.py``).

The codes of all rows live as a device matrix ``bucket_ids [T, cap]`` int32;
a search compares the queries' codes with it block by block and re-ranks
the colliding rows exactly (masking, as the valid-slot mask does).  Two
modes, as in the reference:

  * multi-probe sign LSH (default, ``hamming_radius != 0``): bit-packed
    SimHash codes of at most 31 bits, a row is a candidate iff its Hamming
    distance to the query is <= r in some table.  Tables and radius are
    calibrated on the data at the first search (host numpy over an exact
    k-NN of a 256-row sample, a copy of the reference's arithmetic).
  * exact bucket (``hamming_radius == 0`` or ``bucket_width > 0``): a
    polynomial hash of quantized projections and equality.

PyTorch has no population count: :func:`popcount32` is a SWAR count on
int32 (sign codes keep bit 31 clear, so the XOR of two codes is never
negative and arithmetic shifts are safe).  The polynomial hash wraps int32
by design; :func:`bucket_ids` computes it in int64 and wraps explicitly.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.config import LshConfig
from ..core.store import VectorStore
from ..ops.distance import blocked_knn, pairwise_dist
from ..ops.topk import merge_topk
from .base import (VectorIndex, as_queries, backfill_short_rows,
                   pad_queries_pow2, pow2, to_host_results)

#: candidate-table pool for num_tables=0 (auto) in sign mode: the joint
#: (tables, radius) calibration keeps a prefix of it
_AUTO_TABLE_POOL = 32
#: rows a code computation projects at once ([rows, T*H] f32)
CODE_BLOCK_ROWS = 1 << 16


def _popcount(x: np.ndarray) -> np.ndarray:
    """Vectorized popcount of int32 code matrices (host numpy; a copy of
    the reference's, with its unpackbits fallback for NumPy 1.x)."""
    u = x.view(np.uint32)
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(u)
    bytes_ = u.view(np.uint8).reshape(*u.shape, 4)
    return np.unpackbits(bytes_, axis=-1).sum(axis=-1).astype(u.dtype)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each entry of a non-negative int32 tensor (SWAR),
    computed in place in ``x``."""
    x.sub_((x >> 1).bitwise_and_(0x55555555))
    x = (x & 0x33333333).add_((x >> 2).bitwise_and_(0x33333333))
    x.add_(x >> 4).bitwise_and_(0x0F0F0F0F)
    x.add_(x >> 8)
    x.add_(x >> 16)
    return x.bitwise_and_(0x3F)


def _project(vectors: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """vectors [N, d] x planes [T, H, d] -> projections [T, N, H] f32."""
    t, h, d = planes.shape
    proj = vectors @ planes.reshape(t * h, d).T                   # [N, T*H]
    return proj.reshape(-1, t, h).transpose(0, 1)


def bucket_ids(vectors: torch.Tensor, planes: torch.Tensor,
               width: float) -> torch.Tensor:
    """Quantized-projection bucket ids [T, N] int32: the 31-based
    polynomial hash (start 1, ``h * 31 + floor(proj / width)`` per hash
    function) wrapped to int32 at every step, as the reference's int32
    arithmetic wraps."""
    out = []
    for s in range(0, vectors.shape[0], CODE_BLOCK_ROWS):
        q = torch.floor(_project(vectors[s:s + CODE_BLOCK_ROWS], planes)
                        / width).to(torch.int32).to(torch.int64)
        h = torch.ones(q.shape[:2], dtype=torch.int64, device=q.device)
        for j in range(q.shape[2]):
            h = torch.remainder(h * 31 + q[:, :, j] + 2**31, 2**32) - 2**31
        out.append(h.to(torch.int32))
    return torch.cat(out, dim=1)


def sign_codes(vectors: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Bit-packed sign codes [T, N] int32 (SimHash): bit h of table t is
    ``v . planes[t, h] >= 0``; H <= 31."""
    h = planes.shape[1]
    weights = torch.ones(h, dtype=torch.int32, device=planes.device) \
        << torch.arange(h, dtype=torch.int32, device=planes.device)
    out = []
    for s in range(0, vectors.shape[0], CODE_BLOCK_ROWS):
        proj = _project(vectors[s:s + CODE_BLOCK_ROWS], planes)
        out.append(torch.sum((proj >= 0).to(torch.int32) * weights, dim=2,
                             dtype=torch.int32))
    return torch.cat(out, dim=1)


def lsh_search(queries: torch.Tensor, planes: torch.Tensor, width: float,
               codes: torch.Tensor, base: torch.Tensor, b_norms: torch.Tensor,
               valid: torch.Tensor, k: int, metric: str = "l2",
               block_n: int = 4096, radius: int = 0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The blocked collision scan with a running top-k (the reference's
    ``_lsh_search``): per block of ``block_n`` rows a [T, Q, block]
    collision test reduced over tables (Hamming distance <= ``radius``, or
    equal bucket ids with ``radius`` 0), one distance product masked to
    colliding live rows, and a merge.  The last block is short: nothing is
    padded.  Returns (dists [Q, k], slots [Q, k] int32); +inf / -1 where
    empty."""
    qb = sign_codes(queries, planes) if radius > 0 \
        else bucket_ids(queries, planes, width)                    # [T, Q]
    q_n, n = queries.shape[0], base.shape[0]
    q_norms = torch.sum(queries * queries, dim=1)
    top_d = torch.full((q_n, k), float("inf"), device=queries.device)
    top_i = torch.full((q_n, k), -1, dtype=torch.int32, device=queries.device)
    for start in range(0, n, block_n):
        stop = min(start + block_n, n)
        bid = codes[:, start:stop]
        if radius > 0:
            hd = popcount32(bid[:, None, :] ^ qb[:, :, None])
            hit = torch.any(hd <= radius, dim=0)                   # [Q, B]
        else:
            hit = torch.any(bid[:, None, :] == qb[:, :, None], dim=0)
        d_blk = pairwise_dist(queries, base[start:stop], metric, q_norms,
                              b_norms[start:stop])
        d_blk = d_blk.masked_fill_(~(hit & valid[None, start:stop]),
                                   float("inf"))
        i_blk = torch.arange(start, stop, dtype=torch.int32,
                             device=queries.device).expand(q_n, -1)
        top_d, top_i = merge_topk(top_d, top_i, d_blk, i_blk, k)
    return top_d, top_i


class LshIndex(VectorIndex):
    kind = "lsh"

    def __init__(self, dim: int, capacity: int, metric: str = "l2",
                 config: Optional[LshConfig] = None, device="cuda"):
        super().__init__(dim, capacity, metric)
        self.config = config or LshConfig()
        # sign (multi-probe) mode unless an explicit width or radius 0 opts
        # into exact-bucket semantics
        self._sign_mode = (self.config.bucket_width <= 0
                           and self.config.hamming_radius != 0)
        # auto bit count: sign codes pack the most (31) bits; exact-bucket
        # mode keeps the dimension-aware 16 / 24
        self._bits = self.config.num_bits or (
            31 if self._sign_mode else (16 if dim < 256 else 24))
        # fixed radius (> 0), or None -> calibrated on the data
        self._radius: Optional[int] = (
            0 if not self._sign_mode
            else (self.config.hamming_radius
                  if self.config.hamming_radius > 0 else None))
        if self._sign_mode and self._bits > 31:
            raise ValueError(
                "multi-probe sign codes pack into int32: num_bits <= 31 "
                f"required with hamming_radius != 0, got {self._bits}")
        # table count (num_tables=0 -> auto): calibrated with the radius
        # from a 32-table pool in sign mode, the reference's 10 otherwise
        self._auto_tables = self.config.num_tables == 0 and self._sign_mode
        self._tables = (self.config.num_tables
                        or (_AUTO_TABLE_POOL if self._sign_mode else 10))
        self._tables_final = not self._auto_tables
        self.store = VectorStore(capacity, dim, device=device)
        self.device = self.store.device
        self.seed = 42
        self._gen = 0  # regenerated on build
        self._width: Optional[float] = (
            float(self.config.bucket_width)
            if self.config.bucket_width > 0 else None)
        self.planes = self._make_planes()
        self.bucket_ids = torch.zeros((self._tables, self.store.capacity),
                                      dtype=torch.int32, device=self.device)
        # result rows the collision set left short (backfilled by the exact
        # scan unless config.backfill is False)
        self._backfill_rows = 0
        self._backfill_queries = 0
        # serializes the lazy first-search calibrations among concurrent
        # readers (the facade's lock only excludes writers)
        self._calib_lock = threading.Lock()

    def _make_planes(self) -> torch.Tensor:
        rng = np.random.default_rng(self.seed + 7919 * self._gen)
        planes = rng.standard_normal(
            (self._tables, self._bits, self.dim)).astype(np.float32)
        return torch.as_tensor(planes, device=self.device)

    def _codes(self, vectors: torch.Tensor) -> torch.Tensor:
        if self._sign_mode:
            return sign_codes(vectors, self.planes)
        return bucket_ids(vectors, self.planes, self._effective_width())

    def _sample_nn(self, seed_offset: int, metric: str):
        """A <= 256-row sample of the live rows (a permutation drawn from
        ``default_rng(seed + seed_offset)``) and an exact 2-NN of each:
        (live, sample slots, rng, sample rows, dists [S, 2], slots [S, 2])
        on the host, or None below 8 live rows."""
        st = self.store.state
        live = np.flatnonzero(st.valid.cpu().numpy())
        rng = np.random.default_rng(self.seed + seed_offset)
        if live.size < 8:
            return None
        sample = live[rng.permutation(live.size)[:256]]
        sj = st.vectors[torch.as_tensor(sample, device=self.device)]
        d2, nn = blocked_knn(sj, st.vectors, st.valid, 2, metric=metric,
                             b_norms=st.norms,
                             block_n=min(8192, st.capacity))
        return live, sample, rng, sj, d2.cpu().numpy(), nn.cpu().numpy()

    def _rows(self, slots: np.ndarray) -> torch.Tensor:
        return self.store.state.vectors[torch.as_tensor(slots,
                                                        device=self.device)]

    def _auto_radius(self) -> int:
        """Data-calibrated Hamming radius: the 75th percentile of the
        min-table Hamming distance between sample rows and their true
        nearest neighbors, capped where the binomial union random-collision
        fraction passes 0.35."""
        got = self._sample_nn(13, self.metric)
        if got is None:
            return max(1, self._bits // 4)
        _, _, _, sj, _, nn = got
        nn_np = nn[:, 1]  # column 0 is the row itself
        ok = nn_np >= 0
        if not ok.any():
            return max(1, self._bits // 4)
        qs = sign_codes(sj, self.planes).cpu().numpy()          # [T, S]
        ns = sign_codes(self._rows(nn_np[ok]), self.planes).cpu().numpy()
        hd = _popcount(qs[:, ok] ^ ns)
        r = int(np.percentile(hd.min(axis=0), 75.0))
        b, t = self._bits, self._tables
        cdf = 0.0
        r_cap = 1
        for i in range(b + 1):
            cdf += math.comb(b, i) / (2.0 ** b)
            if 1.0 - (1.0 - cdf) ** t <= 0.35:
                r_cap = i
            else:
                break
        return max(1, min(r, r_cap))

    def _truncate_tables(self, t: int) -> None:
        """Keep the first ``t`` pool tables (the planes are iid, so a prefix
        is an unbiased sample)."""
        if t < int(self.planes.shape[0]):
            self.planes = self.planes[:t].contiguous()
            self.bucket_ids = self.bucket_ids[:t].contiguous()
        self._tables = int(self.planes.shape[0])
        self._tables_final = True

    def _auto_tables_calibrate(self) -> None:
        """Joint (num_tables, radius) calibration in auto-table sign mode:
        on a 256-row sample, the per-table Hamming distances to each row's
        true nearest neighbor and to four random rows; the (t, r) pair
        with the highest neighbor collision rate whose measured random
        collision mass stays <= 0.35 (ties: lower mass, fewer tables,
        tighter radius)."""
        pool = int(self.planes.shape[0])
        got = self._sample_nn(13, self.metric)
        if got is None:
            self._truncate_tables(min(10, pool))
            return
        live, sample, rng, sj, _, nn = got
        nn_np = nn[:, 1]
        ok = nn_np >= 0
        if not ok.any():
            self._truncate_tables(min(10, pool))
            return
        qs = sign_codes(sj, self.planes).cpu().numpy()           # [T, S]
        ns = sign_codes(self._rows(nn_np[ok]), self.planes).cpu().numpy()
        hd_nn = _popcount(qs[:, ok] ^ ns)                        # [T, S']
        reps = 4
        rand_rows = live[rng.integers(0, live.size, size=(sample.size, reps))]
        not_self = (rand_rows != sample[:, None]).reshape(-1)
        rs = sign_codes(self._rows(rand_rows.reshape(-1)),
                        self.planes).cpu().numpy()
        hd_rand = _popcount(np.repeat(qs, reps, axis=1) ^ rs)
        hd_rand = hd_rand[:, not_self]                           # [T, P]
        cmin_nn = np.minimum.accumulate(hd_nn, axis=0)
        cmin_rand = np.minimum.accumulate(hd_rand, axis=0)
        radii = ([self.config.hamming_radius]
                 if self.config.hamming_radius > 0
                 else range(1, self._bits))
        best = None  # ((hit, -mass, -t, -r), t, r)
        for t in (2, 4, 6, 8, 10, 12, 16, 20, 24, 28, 32):
            if t > pool:
                break
            for r in radii:
                mass = float((cmin_rand[t - 1] <= r).mean())
                if mass > 0.35:
                    break  # the mass grows with r
                hit = float((cmin_nn[t - 1] <= r).mean())
                key = (round(hit, 3), -round(mass, 3), -t, -r)
                if best is None or key > best[0]:
                    best = (key, t, r)
        if best is None:
            # even r=1 is over budget (a degenerate corpus): the smallest
            # gate that is still LSH
            self._truncate_tables(min(10, pool))
            if self.config.hamming_radius <= 0:
                self._radius = 1
            return
        _, t, r = best
        self._truncate_tables(t)
        if self.config.hamming_radius <= 0:
            self._radius = int(r)

    def _effective_radius(self) -> int:
        if (self._auto_tables and not self._tables_final) \
                or self._radius is None:
            with self._calib_lock:  # double-checked: one reader calibrates
                if self._auto_tables and not self._tables_final:
                    self._auto_tables_calibrate()
                if self._radius is None:
                    self._radius = self._auto_radius()
        return self._radius

    def _auto_width(self) -> float:
        """Data-calibrated bucket width: 10x the median nearest-neighbor
        distance of a 256-row sample."""
        st = self.store.state
        live = np.flatnonzero(st.valid.cpu().numpy())
        if live.size < 4:
            return 4.0
        rng = np.random.default_rng(self.seed)
        sample = live[rng.permutation(live.size)[:256]]
        d2, _ = blocked_knn(self._rows(sample), st.vectors, st.valid, 2,
                            metric="l2", b_norms=st.norms,
                            block_n=min(8192, st.capacity))
        nn = np.sqrt(np.maximum(d2.cpu().numpy()[:, 1], 0.0))
        med = float(np.median(nn[np.isfinite(nn)]))
        return max(med * 10.0, 1e-6)

    def _effective_width(self) -> float:
        if self._width is None:
            with self._calib_lock:
                if self._width is None:
                    self._width = self._auto_width()
        return self._width

    # ------------------------------------------------------------- mutation
    def add_batch(self, ids: Sequence[int], vectors) -> list[int]:
        accepted, slots = self.store.add_batch(ids, vectors)
        if accepted:
            sl = torch.as_tensor(slots, dtype=torch.long, device=self.device)
            self.bucket_ids[:, sl] = self._codes(self.store.state.vectors[sl])
        return accepted

    def remove(self, vec_id: int) -> bool:
        return self.store.remove(vec_id) is not None

    def build(self) -> None:
        """Regenerate the hash functions and rehash every row; the
        calibrations run again against the current corpus."""
        self._gen += 1
        if self._auto_tables:
            self._tables = _AUTO_TABLE_POOL
            self._tables_final = False
        self.planes = self._make_planes()
        if self.config.bucket_width <= 0:
            self._width = None
        if self._sign_mode and self.config.hamming_radius < 0:
            self._radius = None
        self.bucket_ids = self._codes(self.store.state.vectors)

    # --------------------------------------------------------------- search
    def search_batch(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = as_queries(queries, self.dim, self.device)
        st = self.store.state
        padded, q_n = pad_queries_pow2(q)
        k_eff = min(k, st.capacity)
        k_pad = min(pow2(k_eff), st.capacity)
        if self.store.size() <= k:
            dists, slots = blocked_knn(
                padded, st.vectors, st.valid, k_pad, metric=self.metric,
                b_norms=st.norms, block_n=min(8192, st.capacity))
            return to_host_results(q_n, k, k_eff, slots, st.ids, dists)
        r = self._effective_radius() if self._sign_mode else 0
        dists, slots = lsh_search(
            padded, self.planes, 1.0 if r > 0 else self._effective_width(),
            self.bucket_ids, st.vectors, st.norms, st.valid, k_pad,
            metric=self.metric, block_n=min(4096, st.capacity), radius=r)
        dists, slots = backfill_short_rows(self, padded, q_n, k_eff, k_pad,
                                           dists, slots)
        return to_host_results(q_n, k, k_eff, slots, st.ids, dists)

    # ---------------------------------------------------------------- state
    def size(self) -> int:
        return self.store.size()

    def get(self, vec_id: int) -> Optional[np.ndarray]:
        return self.store.get(vec_id)

    def stats(self) -> dict:
        s = super().stats()
        s.update(
            # the pool size until the calibration truncates it
            num_tables=self._tables,
            num_bits=self._bits,
            bucket_width=(self._effective_width()
                          if not self._sign_mode else 0.0),
            # -1: auto and not calibrated yet (stats never calibrates)
            hamming_radius=(self._radius if self._radius is not None
                            else -1),
            backfill_rows=self._backfill_rows,
            backfill_queries=self._backfill_queries,
        )
        return s

    # ------------------------------------------------------------ persistence
    def state_arrays(self) -> dict:
        return {
            "store": self.store.to_host(),
            "planes": self.planes.cpu().numpy(),
            "bucket_ids": self.bucket_ids.cpu().numpy(),
            "gen": np.asarray([self._gen]),
            # sign mode never reads the width: saving must not calibrate it
            "width": np.asarray([self._width if self._width is not None
                                 else (self._effective_width()
                                       if not self._sign_mode else 0.0)],
                                np.float64),
            "radius": np.asarray([self._radius if self._radius is not None
                                  else -1], np.int64),
            "tables_final": np.asarray([int(self._tables_final)], np.int64),
        }

    def load_state_arrays(self, arrays: dict) -> None:
        dev = self.device
        self.store = VectorStore.from_host(arrays["store"], dev)
        self.planes = torch.tensor(np.asarray(arrays["planes"], np.float32),
                                   device=dev)
        self.bucket_ids = torch.tensor(
            np.asarray(arrays["bucket_ids"], np.int32), device=dev)
        self._gen = int(np.asarray(arrays["gen"])[0])
        if "width" in arrays:
            w = float(np.asarray(arrays["width"])[0])
            self._width = w if w > 0 else None
        if "radius" in arrays:
            r = int(np.asarray(arrays["radius"])[0])
            if self._sign_mode:
                self._radius = r if r >= 0 else None
        self._tables = int(self.planes.shape[0])
        if "tables_final" in arrays:
            self._tables_final = bool(
                int(np.asarray(arrays["tables_final"])[0]))
        else:  # an older checkpoint: infer from the calibrated radius
            self._tables_final = (not self._auto_tables
                                  or self._radius is not None)
