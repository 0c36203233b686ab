"""Flat product-quantization index with an exhaustive ADC scan (the
counterpart of ``vector_db_tpu/index/pq.py``).

Training is one batched k-means over all subspaces (random init, as the
reference's flat PQ), encode one batched argmin, and search a ranked ADC
top-k: by default through the PQ decode kernel (``ops/adc.adc_decode_topk``
on ``ops/kernels.pq_decode_recon_t``, B3), or by the distance-table scans
(``adc_impl`` "gather" / "onehot").  An optional exact re-rank
(``refine_k``) over the raw store lifts recall above pure ADC ranking.

The codes stay ``[cap, S]`` (the reference's state and checkpoint layout);
the decode kernel reads a contiguous ``[S, cap]`` copy, cached with the
reconstruction norms (``core/derived``) on a counter every encode bumps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.config import PqConfig
from ..core.derived import DerivedCache
from ..core.store import VectorStore
from ..ops import adc
from ..ops.distance import blocked_knn, normalize_rows, rerank_columns
from ..ops.kmeans import subspace_kmeans_fit
from ..ops.topk import merge_topk
from .base import (VectorIndex, as_queries, pad_queries_pow2, pow2,
                   to_host_results)
from .hnsw_pq import _build_fast_tables


class PqIndex(VectorIndex):
    kind = "pq"

    def __init__(self, dim: int, capacity: int, metric: str = "l2",
                 config: Optional[PqConfig] = None, device="cuda"):
        # private copy: the subspace adjustment must not leak into a config
        # shared across indexes
        config = dataclasses.replace(config) if config else PqConfig()
        sub = min(config.num_subspaces, dim)
        while dim % sub != 0:
            sub -= 1
        config.num_subspaces = sub
        super().__init__(dim, capacity, metric)
        self.config = config
        self.store = VectorStore(capacity, dim, device=device)
        self.device = self.store.device
        self.codebooks: Optional[torch.Tensor] = None  # [S, K, sub_dim]
        self.codes = torch.zeros((self.store.capacity, sub), dtype=torch.uint8,
                                 device=self.device)
        self.trained = False
        self.seed = 42
        # "decode": B3 + one product (the default); "gather" / "onehot":
        # the distance-table scans
        self.adc_impl = "decode"
        # variance-balancing dimension permutation (PQ space = rows[:, perm])
        self.perm: Optional[torch.Tensor] = None
        self._codes_version = 0
        self._fast = DerivedCache()

    # ------------------------------------------------------------- mutation
    def add_batch(self, ids: Sequence[int], vectors) -> list[int]:
        accepted, slots = self.store.add_batch(ids, vectors)
        if accepted and self.trained:
            self._encode_slots(np.asarray(slots, np.int64))
        return accepted

    def remove(self, vec_id: int) -> bool:
        return self.store.remove(vec_id) is not None

    # --------------------------------------------------------------- train
    def _pq_space(self, rows: torch.Tensor) -> torch.Tensor:
        return normalize_rows(rows) if self.metric == "cosine" else rows

    def train(self) -> bool:
        """Train the codebooks on every live row, then encode them."""
        if self.store.size() < self.config.num_centroids:
            return False
        st = self.store.state
        live = np.flatnonzero(st.valid.cpu().numpy())
        data = self._pq_space(st.vectors[torch.as_tensor(live,
                                                         device=self.device)])
        if self.config.balance_dims:
            v = torch.var(data, dim=0, unbiased=False).cpu().numpy()
            self.perm = torch.as_tensor(
                adc.balanced_subspace_perm(v, self.config.num_subspaces),
                device=self.device)
            data = data[:, self.perm]
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.codebooks = subspace_kmeans_fit(
            gen, data, self.config.num_subspaces,
            k=self.config.num_centroids,
            iters=self.config.training_iterations, plus_plus=False)
        self.trained = True
        self._encode_slots(live)
        return True

    def build(self) -> None:
        self.train()

    def _encode_slots(self, slots: np.ndarray) -> None:
        if slots.size == 0:
            return
        sl = torch.as_tensor(slots, device=self.device)
        vecs = self._pq_space(self.store.state.vectors[sl])
        if self.perm is not None:
            vecs = vecs[:, self.perm]
        self.codes[sl] = adc.pq_encode(vecs, self.codebooks)
        self._codes_version += 1

    def _fast_tables(self) -> tuple:
        """(codes_t [S, cap] uint8 contiguous, cbt [S*sd, K], reconstruction
        norms [cap]) for the decode kernel, current with the codes: rebuilt
        after an encode (``hnsw_pq._build_fast_tables``)."""
        return self._fast.get(self._codes_version, self._build_fast_tables)

    def _build_fast_tables(self) -> tuple:
        return _build_fast_tables(self.codes, self.codebooks)

    # --------------------------------------------------------------- search
    def search_batch(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = as_queries(queries, self.dim, self.device)
        st = self.store.state
        padded, q_n = pad_queries_pow2(q)
        k_eff = min(k, st.capacity)
        k_pad = min(pow2(k_eff), st.capacity)

        if not self.trained or self.store.size() <= k:
            dists, slots = blocked_knn(
                padded, st.vectors, st.valid, k_pad, metric=self.metric,
                b_norms=st.norms, block_n=min(8192, st.capacity))
            return to_host_results(q_n, k, k_eff, slots, st.ids, dists)

        refine_k = self.config.refine_k
        if self.metric == "cosine":
            # ADC values are subspace squared L2: an exact cosine refine
            # keeps the result currency of every other index
            refine_k = max(refine_k, 4 * k_eff, 64)
        q_adc = self._pq_space(padded)

        def adc_topk(r):
            if self.adc_impl == "decode":
                ct, cbt, cnorms = self._fast_tables()
                return adc.adc_decode_topk(q_adc, ct, cbt, st.valid, r,
                                           code_norms=cnorms, perm=self.perm)
            q_pq = q_adc if self.perm is None else q_adc[:, self.perm]
            tables = adc.build_distance_tables(q_pq, self.codebooks)
            return adc.adc_scan_topk(tables, self.codes, st.valid, r,
                                     block_n=min(4096, st.capacity),
                                     impl=self.adc_impl)

        if refine_k and refine_k > k_eff:
            # ADC shortlist, then an exact re-rank over the raw store
            _, cand = adc_topk(min(pow2(refine_k), st.capacity))
            dists, slots = refine_exact(padded, st.vectors, cand, k_pad,
                                        self.metric)
        else:
            dists, slots = adc_topk(k_pad)
        return to_host_results(q_n, k, k_eff, slots, st.ids, dists)

    # ---------------------------------------------------------------- state
    def size(self) -> int:
        return self.store.size()

    def get(self, vec_id: int) -> Optional[np.ndarray]:
        return self.store.get(vec_id)

    def stats(self) -> dict:
        s = super().stats()
        s.update(
            trained=self.trained,
            num_subspaces=self.config.num_subspaces,
            num_centroids=self.config.num_centroids,
            compression_ratio=4.0 * self.dim / self.config.num_subspaces,
            code_bytes=self.store.capacity * self.config.num_subspaces,
        )
        return s

    # ------------------------------------------------------------ persistence
    def state_arrays(self) -> dict:
        out = {"store": self.store.to_host(),
               "codes": self.codes.cpu().numpy(),
               "trained": np.asarray([self.trained])}
        if self.codebooks is not None:
            out["codebooks"] = self.codebooks.cpu().numpy()
        if self.perm is not None:
            out["perm"] = self.perm.cpu().numpy()
        return out

    def load_state_arrays(self, arrays: dict) -> None:
        dev = self.device
        self.store = VectorStore.from_host(arrays["store"], dev)
        self.codes = torch.tensor(np.asarray(arrays["codes"], np.uint8),
                                  device=dev)
        self._codes_version += 1
        self._fast.void()
        self.trained = bool(np.asarray(arrays["trained"])[0])
        self.codebooks = (torch.tensor(np.asarray(arrays["codebooks"],
                                                  np.float32), device=dev)
                          if "codebooks" in arrays else None)
        self.perm = (torch.tensor(np.asarray(arrays["perm"], np.int64),
                                  device=dev) if "perm" in arrays else None)


def refine_exact(queries: torch.Tensor, base: torch.Tensor,
                 cand_slots: torch.Tensor, k: int, metric: str
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of candidate slots [Q, R] (-1 padded), in the
    reference's formulas: squared L2 by direct difference sum((v - q)^2),
    cosine as 1 - q.v / max(|q| |v|, 1e-12).  Candidate columns go in
    blocks of ``ops/distance.rerank_columns`` with a running top-k, never
    the whole [Q, R, d] gather.  Returns (dists [Q, k], slots
    [Q, k]) ascending; +inf / -1 where empty."""
    q_n, r = cand_slots.shape
    rb = min(r, rerank_columns(q_n, base.shape[1]))
    top_d = torch.full((q_n, k), float("inf"), device=queries.device)
    top_i = torch.full((q_n, k), -1, dtype=cand_slots.dtype,
                       device=queries.device)
    qn = torch.linalg.vector_norm(queries, dim=1, keepdim=True)
    for start in range(0, r, rb):
        cnd = cand_slots[:, start:start + rb]
        vecs = base[cnd.clamp(min=0).long()]                  # [Q, rb, d]
        if metric == "l2":
            d = torch.sum((vecs - queries[:, None, :]).square_(), dim=2)
        else:
            vn = torch.linalg.vector_norm(vecs, dim=2)
            dot = torch.bmm(vecs, queries[:, :, None])[:, :, 0]
            d = 1.0 - dot / torch.clamp(qn * vn, min=1e-12)
        d = d.masked_fill_(cnd < 0, float("inf"))
        top_d, top_i = merge_topk(top_d, top_i, d, cnd, k)
    return top_d, top_i
