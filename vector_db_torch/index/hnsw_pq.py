"""HNSW+PQ flagship index, raw f32 store, scan search (the counterpart of
``vector_db_tpu/index/hnsw_pq.py`` without the graph).

PQ codebooks train on the live corpus (lazily at the training threshold,
or at ``bulk_load``), every row is encoded, and ``search_batch`` scans:

  * ``scan_exact`` — the exact f32 scan over the raw store
    (:func:`exact_scan_search`: ``torch.matmul`` + exact top-k);
  * ``scan_pallas_int8`` — the int8 pool kernel
    (``ops/kernels.fused_int8_pool``, CUDA on the card) over a per-row
    quantized, centered int8 shadow of the store, then an exact f32
    re-rank of the pool (:func:`pallas_scan8_refine`);
  * ``auto`` — scan_exact below 700,000 live rows, scan_pallas_int8 at and
    above (the reference's crossover, :func:`_auto_scan_mode`).

The other modes, the graph, the compressed store and the IVF tier raise
``NotImplementedError`` naming their ROADMAP item.  Unlike the reference,
no [L, cap, M] graph is allocated when ``use_graph=False``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.config import HnswPqConfig
from ..core.store import VectorStore
from ..ops import adc
from ..ops.distance import (blocked_knn, blocked_knn_fast, blocked_rerank,
                            normalize_rows)
from ..ops.kernels import fused_int8_pool
from ..ops.kmeans import subspace_kmeans_fit
from .base import (VectorIndex, as_queries, pad_queries_pow2, pow2,
                   to_host_results)

#: search modes the port serves, and the ROADMAP item that ports each other
PORTED_MODES = ("auto", "scan_exact", "scan_pallas_int8")
_MODE_ROADMAP = {
    "adc_fast": "A9", "scan_int8": "A9", "scan_bf16": "A10",
    "scan_pallas": "A10", "pca": "A10", "adc": "A10", "graph": "A10",
    "scan_ivf": "A12",
}
#: live rows at which auto switches from scan_exact to scan_pallas_int8
AUTO_INT8_MIN_ROWS = 700_000
#: rows of the int8 shadow are padded to a multiple of this (the pool width)
SHADOW_PAD_ROWS = 2048
#: store rows quantized per step of a full shadow build
SHADOW_BUILD_ROWS = 1 << 16


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


class HnswPqIndex(VectorIndex):
    kind = "hnswpq"

    def __init__(self, dim: int, capacity: int, metric: str = "l2",
                 config: Optional[HnswPqConfig] = None, device="cuda"):
        # private copy: num_subspaces is adjusted below
        config = dataclasses.replace(config) if config else HnswPqConfig()
        sub = min(config.num_subspaces, dim)
        while dim % sub != 0:
            sub -= 1
        config.num_subspaces = sub
        super().__init__(dim, capacity, metric)
        if not config.raw_store:
            raise _not_ported("raw_store=False (the compressed tier)", "A9")
        if config.refine_residual:
            raise ValueError("refine_residual=True needs the compressed store "
                             "(raw_store=False)")
        if config.use_graph:
            raise _not_ported("use_graph=True (graph search)", "A10")
        if config.search_mode not in PORTED_MODES:
            raise _not_ported(f"search_mode={config.search_mode!r}",
                              _MODE_ROADMAP.get(config.search_mode, "A10"))
        if config.int8_epilogue != "per_row":
            raise _not_ported("int8_epilogue='global' (kernel B7)", "A10")
        if config.nlist > 0:
            raise _not_ported("nlist > 0 (the IVF coarse quantizer)", "A12")
        self.config = config
        self.store = VectorStore(capacity, dim, device=device)
        self.device = self.store.device
        self.codes = torch.zeros((self.store.capacity, sub), dtype=torch.uint8,
                                 device=self.device)
        self.codebooks: Optional[torch.Tensor] = None  # [S, K, sub_dim]
        self.perm: Optional[torch.Tensor] = None  # PQ space = vectors[:, perm]
        self.trained = False
        self.seed = 42
        self._level_counter = 0  # checkpoint field of the reference's graph
        # int8 scan shadow: (store.version, (base8, off, sc, center_vec)),
        # its centering constant, and the store rows written since it was
        # built ([] = none, None = unknown -> full rebuild)
        self._scan8_cache: Optional[tuple] = None
        self._scan8_aux: Optional[torch.Tensor] = None
        self._scan8_dirty: Optional[list] = []
        # concurrent searches must not both refresh the shadow in place
        self._cache_lock = threading.Lock()

    # ------------------------------------------------------------- mutation
    def _note_row_mutation(self, slots: np.ndarray) -> None:
        """Record rows for the shadow's incremental refresh; past
        max(8192, capacity / 8) rows the record degrades to a rebuild."""
        if self._scan8_dirty is None:
            return
        self._scan8_dirty.append(np.asarray(slots, np.int64).ravel())
        limit = max(8192, self.store.capacity // 8)
        if sum(a.size for a in self._scan8_dirty) > limit:
            self._scan8_dirty = None

    def _note_store_rewrite(self) -> None:
        """An untracked rewrite of the whole store: rebuild the shadow."""
        self._scan8_dirty = None

    def add_batch(self, ids: Sequence[int], vectors) -> list[int]:
        accepted, slots = self.store.add_batch(ids, vectors)
        if not accepted:
            return []
        slots_np = np.asarray(slots, np.int64)
        self._note_row_mutation(slots_np)
        if not self.trained:
            # lazy training: buffer until the threshold, then train + encode
            threshold = min(self.config.training_samples,
                            max(self.capacity // 10, 256))
            if self.store.size() >= max(threshold, self.config.num_centroids):
                self.train()
        else:
            self._encode_slots(slots_np)
        return accepted

    def bulk_load(self, ids: Sequence[int], vectors) -> list[int]:
        """Bulk ingest of an [n, dim] corpus (ideally already on the
        index's device) into an empty index, then train + encode."""
        accepted = self.store.bulk_load(ids, vectors)
        self._note_store_rewrite()
        if accepted:
            self.train()
        return accepted

    def remove(self, vec_id: int) -> bool:
        slot = self.store.remove(vec_id)
        if slot is None:
            return False
        self._note_row_mutation(np.asarray([slot]))
        return True

    # --------------------------------------------------------------- train
    def train(self) -> bool:
        """Per-subspace k-means++ PQ training on up to ``training_samples``
        live rows (the same host-side sample as the reference), then encode
        every live row."""
        if self.store.size() < self.config.num_centroids:
            return False
        live = np.flatnonzero(self.store.state.valid.cpu().numpy())
        sample = live
        if sample.size > self.config.training_samples:
            rng = np.random.default_rng(self.seed)
            sample = rng.choice(sample, self.config.training_samples,
                                replace=False)
        data = self.store.rows(np.sort(sample))
        if self.metric == "cosine":
            data = normalize_rows(data)
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
            iters=self.config.training_iterations, plus_plus=True)
        self.trained = True
        self._encode_slots(live)
        return True

    def build(self) -> None:
        """Train if needed, else re-encode every live row."""
        if not self.trained:
            self.train()
        else:
            self._encode_slots(
                np.flatnonzero(self.store.state.valid.cpu().numpy()))

    def _encode_slots(self, slots: np.ndarray) -> None:
        """PQ-encode the given slots, in chunks whose [S, rows, K] distance
        block fits ``adc.ENCODE_CHUNK_BYTES``."""
        if self.codebooks is None or len(slots) == 0:
            return
        s, k, _ = self.codebooks.shape
        chunk = max(1, adc.ENCODE_CHUNK_BYTES // (4 * s * k))
        slots_t = torch.as_tensor(np.asarray(slots), dtype=torch.long,
                                  device=self.device)
        for start in range(0, slots_t.numel(), chunk):
            sl = slots_t[start:start + chunk]
            self.codes[sl] = adc.pq_encode(
                self._pq_space(self.store.state.vectors[sl]), self.codebooks)

    def _pq_space(self, vecs: torch.Tensor) -> torch.Tensor:
        """Vectors as the quantizer sees them: normalized under cosine,
        then dimension-permuted."""
        if self.metric == "cosine":
            vecs = normalize_rows(vecs)
        if self.perm is not None:
            vecs = vecs[:, self.perm]
        return vecs

    # ---------------------------------------------------------- int8 shadow
    def _scan8_shadow(self) -> tuple:
        """(base8, off, sc, center_vec) for scan_pallas_int8, current with
        the store.  Rows written since the last build are requantized
        against the cached centering (_update_scan8_shadow, O(dirty * d));
        an unknown or over-threshold rewrite rebuilds it whole."""
        with self._cache_lock:
            st = self.store.state
            cache = self._scan8_cache
            if cache is not None and cache[0] == self.store.version:
                return cache[1]
            slots = None
            if cache is not None and self._scan8_aux is not None \
                    and self._scan8_dirty:
                slots = torch.as_tensor(
                    np.unique(np.concatenate(self._scan8_dirty)),
                    device=self.device)
            if slots is not None:
                shadow = cache[1]
                _update_scan8_shadow(*shadow[:3], st.vectors, st.norms,
                                     st.valid, slots, shadow[3],
                                     self._scan8_aux, self.metric)
            else:
                *shadow, self._scan8_aux = _build_scan8_shadow(
                    st.vectors, st.norms, st.valid, self.metric,
                    SHADOW_PAD_ROWS)
            self._scan8_cache = (self.store.version, tuple(shadow))
            self._scan8_dirty = []
            return self._scan8_cache[1]

    # --------------------------------------------------------------- search
    def _f32_scan_block(self, capacity: int, q_n: int) -> int:
        """Block length of the blocked exact scan: few big blocks, the
        [Q, block] f32 buffer capped at ~1 GB."""
        block = max(32768, min(1 << 20, (1 << 28) // max(q_n, 1)))
        return min(block - block % 128, max(capacity, 128))

    def search_batch(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = as_queries(queries, self.dim, self.device)
        st = self.store.state
        n_live = self.store.size()
        padded, q_n = pad_queries_pow2(q)
        k_eff = min(k, st.capacity)
        k_pad = min(pow2(k_eff), st.capacity)

        if not self.trained or n_live <= k:
            # exact fallback until trained, and whenever every row is wanted
            dists, slots = blocked_knn(
                padded, st.vectors, st.valid, k_pad, metric=self.metric,
                b_norms=st.norms, block_n=min(8192, st.capacity))
            return to_host_results(q_n, k, k_eff, slots, st.ids, dists)

        mode = self.config.search_mode
        if mode == "auto":
            mode = _auto_scan_mode(self.config.use_graph, n_live)
        if mode == "scan_pallas_int8":
            base8, off, sc, cvec = self._scan8_shadow()
            w = min(SHADOW_PAD_ROWS, base8.shape[0])
            dists, ext = pallas_scan8_refine(
                padded, st.vectors, base8, off, sc, cvec, st.ids, k_pad,
                self.metric, pool=min(max(4 * k_pad, 64), w), w=w)
        elif mode == "scan_exact":
            dists, ext = exact_scan_search(
                padded, st.vectors, st.norms, st.valid, st.ids, k_pad,
                self.metric, self._f32_scan_block(st.capacity, padded.shape[0]))
        else:
            raise _not_ported(f"search_mode={mode!r}",
                              _MODE_ROADMAP.get(mode, "A10"))
        return to_host_results(q_n, k, k_eff, ext, None, dists)

    # ---------------------------------------------------------------- state
    def size(self) -> int:
        return self.store.size()

    def get(self, vec_id: int) -> Optional[np.ndarray]:
        return self.store.get(vec_id)

    def stats(self) -> dict:
        s = super().stats()
        sub = self.config.num_subspaces
        code_bytes = self.store.capacity * sub
        cb_bytes = (self.codebooks.numel() * 4
                    if self.codebooks is not None else 0)
        raw_bytes = self.store.capacity * self.dim * 4
        s.update(
            trained=self.trained,
            num_subspaces=sub,
            num_centroids=self.config.num_centroids,
            compression_ratio=4.0 * self.dim / sub,
            index_bytes=code_bytes + cb_bytes,
            proxy_bytes=0,
            raw_bytes=raw_bytes,
            store_bytes=raw_bytes,
            raw_store=True,
            use_graph=False,
            pending_inserts=0,
            device=str(self.device),
        )
        return s

    # ------------------------------------------------------------ persistence
    def state_arrays(self) -> dict:
        """Host arrays under the reference's checkpoint keys (no graph)."""
        out = {
            "store": self.store.to_host(),
            "codes": self.codes.cpu().numpy(),
            "trained": np.asarray([self.trained]),
            "level_counter": np.asarray([self._level_counter]),
        }
        if self.codebooks is not None:
            out["codebooks"] = self.codebooks.cpu().numpy()
        if self.perm is not None:
            out["perm"] = self.perm.cpu().numpy()
        return out

    def load_state_arrays(self, arrays: dict) -> None:
        """Load ``state_arrays()`` of either package (numpy arrays; the
        reference's graph and other modes' state are ignored) onto this
        index's device."""
        dev = self.device
        self.store = VectorStore.from_host(arrays["store"], dev)
        self.codes = torch.tensor(np.asarray(arrays["codes"], np.uint8),
                                     device=dev)
        self.trained = bool(np.asarray(arrays["trained"])[0])
        self._level_counter = int(np.asarray(arrays["level_counter"])[0])
        self.codebooks = (
            torch.tensor(np.asarray(arrays["codebooks"], np.float32),
                            device=dev)
            if "codebooks" in arrays else None)
        self.perm = (torch.tensor(np.asarray(arrays["perm"], np.int64),
                                     device=dev)
                     if "perm" in arrays else None)
        self._scan8_cache = None
        self._note_store_rewrite()


def _auto_scan_mode(use_graph: bool, n_live: int) -> str:
    """search_mode="auto": graph only when configured, the exact scan below
    700,000 live rows, the int8 pool kernel at and above (the reference's
    crossover, measured on its own hardware; the port's is ROADMAP A8)."""
    if use_graph:
        return "graph"
    if n_live >= AUTO_INT8_MIN_ROWS:
        return "scan_pallas_int8"
    return "scan_exact"


def _quantize_shadow_rows(rows, rnorms, rvalid, cvec, aux, metric):
    """Shadow rows for the given store rows against a fixed centering:
    (r8 int8, off f32, sc f32).  Shared by the full build and the
    incremental update, so both quantize exactly alike.

      * sq-L2: r8 = round((v - mu) / sv), sv = max|v - mu| / 127;
        off = ||v - mu||^2 (exact f32); sc = -2 sv.
      * cosine: r8 = round((v_hat - c0 cdir) / sv); off = -(v_hat . cdir);
        sc = -sv.

    Dead rows get off = +inf."""
    if metric == "cosine":
        vhat = rows * torch.rsqrt(torch.clamp(rnorms, min=1e-12))[:, None]
        ctr = vhat - aux * cvec[None, :]
        off = -(vhat @ cvec)
        sgn = -1.0
    else:
        ctr = rows - cvec[None, :]
        off = rnorms + aux - 2.0 * (rows @ cvec)
        sgn = -2.0
    sv = torch.clamp(torch.amax(torch.abs(ctr), dim=1), min=1e-12) / 127.0
    r8 = torch.clamp(torch.round(ctr / sv[:, None]), -127, 127).to(torch.int8)
    off = torch.where(rvalid, off, float("inf"))
    return r8, off, sgn * sv


def _build_scan8_shadow(vectors, norms, valid, metric, pad_to):
    """int8 scan shadow of the whole store: (base8 [N', d'] int8, off [N'],
    sc [N'], center_vec [d], aux).  N' pads the rows to a multiple of
    ``pad_to`` (off = +inf, sc = 0) and d' the columns to a multiple of 4
    with zeros (whole 4-byte words for the kernel); both paddings happen
    here, once per build, never per search.

    The centering comes from the live rows of the first 4096 slots: mu for
    sq-L2 (aux = |mu|^2), the mean direction cdir scaled by the mean cosine
    c0 for cosine (aux = c0).  Rows are quantized SHADOW_BUILD_ROWS at a
    time.
    """
    n, d = vectors.shape
    m = min(4096, n)
    pref = vectors[:m]
    w = valid[:m].to(torch.float32)
    wsum = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(pref * w[:, None], dim=0) / wsum
    musq = torch.sum(mu * mu)
    if metric == "cosine":
        cvec = mu * torch.rsqrt(torch.clamp(musq, min=1e-12))
        pn = torch.sqrt(torch.clamp(torch.sum(pref * pref, dim=1), min=1e-12))
        aux = torch.sum((pref @ cvec) / pn * w) / wsum
    else:
        cvec, aux = mu, musq
    n_pad = n + (-n) % pad_to
    d_pad = d + (-d) % 4
    dev = vectors.device
    base8 = torch.zeros((n_pad, d_pad), dtype=torch.int8, device=dev)
    off = torch.full((n_pad,), float("inf"), device=dev)
    sc = torch.zeros((n_pad,), device=dev)
    for s in range(0, n, SHADOW_BUILD_ROWS):
        e = min(n, s + SHADOW_BUILD_ROWS)
        r8, off[s:e], sc[s:e] = _quantize_shadow_rows(
            vectors[s:e], norms[s:e], valid[s:e], cvec, aux, metric)
        base8[s:e, :d] = r8
    return base8, off, sc, cvec, aux


def _update_scan8_shadow(base8, off, sc, vectors, norms, valid, slots, cvec,
                         aux, metric) -> None:
    """Requantize only ``slots`` against the cached centering, in place."""
    r8, off_s, sc_s = _quantize_shadow_rows(
        vectors[slots], norms[slots], valid[slots], cvec, aux, metric)
    base8[slots, :r8.shape[1]] = r8
    off[slots] = off_s
    sc[slots] = sc_s


def _pool_select_cand(queries, center_vec, metric, pool_kernel, pool_args,
                      pool, w):
    """Center (and under cosine normalize) the queries, run the pool
    kernel, and keep the ``pool`` best of the [Q, w] bucket winners with an
    exact top-k: candidate slots [Q, pool], -1 where empty.  (The
    reference selects with ``approx_max_k(recall_target=0.95)``.)"""
    q = normalize_rows(queries) if metric == "cosine" else queries
    qc = q - center_vec[None, :]
    vals, idx = pool_kernel(qc, *pool_args, w)
    nv, sel = torch.topk(vals, pool, dim=1, largest=False, sorted=True)
    cand = torch.gather(idx, 1, sel)
    return torch.where(torch.isfinite(nv), cand, torch.full_like(cand, -1))


def pallas_scan8_refine(queries, base, base8, off, sc, center_vec, ids, k,
                        metric, pool, w):
    """int8 pool kernel scan + exact f32 re-rank of the pool: returns
    (dists [Q, k], external ids [Q, k], -1 where empty).  The name is the
    reference's; the pool runs ``ops/kernels.fused_int8_pool``."""
    cand = _pool_select_cand(queries, center_vec, metric, fused_int8_pool,
                             (base8, off, sc), pool, w)
    d, slots = blocked_rerank(queries, base, cand, k, metric, rb=pool)
    ext = torch.where(torch.isfinite(d), ids[slots.clamp(min=0).long()],
                      torch.full_like(slots, -1))
    return d, ext


def exact_scan_search(queries, base, norms, valid, ids, k, metric, block_n):
    """Exact f32 scan + external-id map: the flagship's search below the
    crossover."""
    d, slots = blocked_knn_fast(queries, base, valid, k, metric=metric,
                                b_norms=norms, block_n=block_n)
    ext = torch.where(slots >= 0, ids[slots.clamp(min=0).long()],
                      torch.full_like(slots, -1))
    return d, ext
