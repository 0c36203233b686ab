"""HNSW+PQ flagship index, raw f32 or compressed int8 store (the
counterpart of ``vector_db_tpu/index/hnsw_pq.py``).

PQ codebooks train on the live corpus (lazily at the training threshold,
at ``bulk_load``, or on the first chunk of ``bulk_load_stream``), every
row is encoded, and ``search_batch`` scans:

  * ``scan_exact`` (raw store) — the exact f32 scan
    (:func:`exact_scan_search`: ``torch.matmul`` + exact top-k);
  * ``scan_pallas_int8`` — the int8 pool kernel with a re-rank of the pool:
    over a per-row quantized, centered int8 shadow of a raw store
    (``ops/kernels.fused_int8_pool``, :func:`pallas_scan8_refine`), or with
    ``int8_epilogue="global"`` over a global-scale shadow ranked in int32
    (``ops/kernels.fused_int8g_pool``, :func:`pallas_scan8g_refine`), or
    directly over a compressed store's packed rows
    (``ops/kernels.fused_packed_pool``, :func:`pallas_scan8p_refine`);
  * ``scan_pallas`` (raw store) — the bf16 pool kernel over a centered bf16
    shadow (``ops/kernels.fused_raw_pool``, :func:`pallas_scan_refine`);
  * ``scan_bf16`` (raw store) — bf16 selection scores from a bf16 product
    (``ops/distance.bf16_pool_scan``, no pool kernel) and an exact re-rank
    (:func:`bf16_scan_refine`);
  * ``adc_fast`` — decode the codes (``ops/kernels.pq_decode_recon_t``),
    score against the reconstruction, pool, re-rank against the refine
    store (``ops/adc.adc_fast_search``); with ``adc_pool="fused"`` one
    kernel decodes, scores and pools (``ops/kernels.fused_adc_pool``);
  * ``scan_int8`` — the exhaustive scan over int8 rows (the compressed
    store, or a raw store with ``refine_store="int8"``);
  * ``scan_ivf`` — the cluster-pruned scan (``ops/ivf_scan``): a coarse
    k-means quantizer (``nlist`` centroids, 0 auto-sizes it at training), a
    balanced cluster-major int8 layout of the live rows, ``nprobe`` probed
    clusters a query scored by ``ops/kernels.fused_ivf_pool``, then the
    exact f32 (raw store) or int8 + residual (compressed) refine, with the
    rows written since the last layout scored exactly beside the pool
    (:func:`pallas_ivf_refine_raw`, :func:`pallas_ivf_refine_packed`);
  * ``pca`` — a bf16 PCA projection of the rows (the proxy, fitted at
    training under ``search_mode="pca"``, kept current by every encode) is
    scanned, its ranked top-``pca_r`` re-ranked (``ops/pca``);
  * ``adc`` — per-query distance tables scanned over the [N, S] codes
    (:func:`flagship_search`), or with ``nlist > 0`` over the members of
    the ``nprobe`` nearest coarse clusters from a quota + overflow member
    table (:func:`flagship_search_pruned`), ``refine_k`` candidates
    re-ranked;
  * ``graph`` (``use_graph=True``, raw store) — an HNSW graph over the
    rows (``ops/hnsw_graph``), built with exact distances, traversed with
    ADC distances (:func:`hnsw_pq_search`), the beam's pool re-ranked
    exactly; adds are deferred as in ``index/hnsw.py`` and answered through
    an exact overlay (:func:`_graph_refine_pending`);
  * ``auto`` — the graph when ``use_graph``; else raw store: scan_exact
    below 700,000 live rows, scan_pallas_int8 at and above (the reference's
    crossover, :func:`_auto_scan_mode`); compressed store: adc_fast.

On the card, a search of at most 8 queries under ``scan_exact`` or the
per-row ``scan_pallas_int8`` of a raw store replays its padded-8 program
from a CUDA graph (``index/q8graph.py``, :meth:`HnswPqIndex._mode_program`):
the same launches on the same tensors, so the same answers.

The compressed store (``raw_store=False``) keeps int8 rows, exact norms
and optionally a residual level (``refine_residual``) and no f32 matrix;
``bulk_load_stream`` fills it chunk by chunk.  What a search derives from
the store or the codes (the scan shadows, the refine rows, the ADC tables,
the scan_ivf layout, the member table, the proxy norms) is one registry of
``core/derived.DerivedCache`` (:class:`_Caches`), keyed on version counters
(``store.version``, the codes' own ``_codes_version``): the port writes in
place, so the reference's array-identity keys would never change.  Every
row write is noted in the row-keyed caches' records; an untracked rewrite
or a reload voids them all.  Unlike the reference, the [L, cap, M] graph
is allocated only under ``use_graph=True``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.config import HnswPqConfig
from ..core.derived import DerivedCache
from ..core.member_table import build_member_table
from ..core.store import VectorStore
from ..ops import adc, ivf_scan, pca
from ..ops import hnsw_graph as hg
from ..ops.distance import (bf16_pool_scan, blocked_knn, blocked_knn_fast,
                            blocked_knn_int8, blocked_rerank,
                            blocked_rerank_int8, normalize_rows,
                            pack_bf16_rows, pack_int8_rows, pairwise_sq_l2,
                            words_to_f32)
from ..ops.kernels import (IVF_PW, LANES, fused_int8_pool, fused_int8g_pool,
                           fused_packed_pool, fused_raw_pool,
                           pq_decode_recon_t, preserved_pool_width)
from ..ops.topk import merge_topk
from ..ops.kmeans import kmeans_fit, kmeans_fit_blocked, subspace_kmeans_fit
from ..utils.stats import GLOBAL, span
from . import q8graph
from .base import (DeferInsertMixin, VectorIndex, as_queries,
                   pad_queries_pow2, pow2, slot_ids, to_host_results)
from .hnsw import (fix_entry_after_unlink, graph_from_host, graph_to_host,
                   sample_graph_levels)

#: modes that read the raw f32 rows (refused by a compressed store)
RAW_ONLY_MODES = ("scan_exact", "scan_pallas", "scan_bf16", "graph")
#: live rows at which auto switches from scan_exact to scan_pallas_int8
AUTO_INT8_MIN_ROWS = 700_000
#: rows of the scan shadows are padded to a multiple of this (the pool width)
SHADOW_PAD_ROWS = 2048
#: store rows quantized (or decoded) per step of a full shadow build
SHADOW_BUILD_ROWS = 1 << 16
#: code columns decoded per step of the reconstruction-norm pass
RECON_NORM_CHUNK = 1 << 19
#: rows per step of the coarse assignment and of the layout's choices pass
#: is (1 << 26) // nlist: a [rows, nlist] f32 block of at most 256 MB
COARSE_BLOCK_ELEMS = 1 << 26


class _Caches(NamedTuple):
    """HnswPqIndex's derived caches (``core/derived``), each read through
    one getter.  The first five are keyed on ``store.version`` and noted
    every row write, ``scan8p`` keyed on it too, ``fast`` on
    ``_codes_version``; the last two are voided by hand."""

    scan8: DerivedCache
    scan8g: DerivedCache
    scan16: DerivedCache
    refine: DerivedCache
    ivf: DerivedCache
    scan8p: DerivedCache
    fast: DerivedCache
    members: DerivedCache
    proxy_norms: DerivedCache


class HnswPqIndex(DeferInsertMixin, VectorIndex):
    kind = "hnswpq"

    def __init__(self, dim: int, capacity: int, metric: str = "l2",
                 config: Optional[HnswPqConfig] = None, device="cuda"):
        # private copy: num_subspaces / refine_store are adjusted below
        config = dataclasses.replace(config) if config else HnswPqConfig()
        sub = min(config.num_subspaces, dim)
        while dim % sub != 0:
            sub -= 1
        config.num_subspaces = sub
        super().__init__(dim, capacity, metric)
        if not config.raw_store:
            # the compressed tier holds no f32 rows: refuse what needs them
            if dim % 4 != 0:
                raise ValueError("raw_store=False requires dim % 4 == 0")
            if config.use_graph:
                raise ValueError(
                    "raw_store=False is incompatible with use_graph=True "
                    "(graph construction reads raw rows); use the scan modes")
            if config.search_mode in RAW_ONLY_MODES:
                raise ValueError(
                    f"search_mode={config.search_mode!r} needs the raw f32 "
                    "store; with raw_store=False use adc_fast | pca | adc | "
                    "scan_int8 | scan_pallas_int8 | auto")
            config.refine_store = "int8"
        elif config.refine_residual:
            raise ValueError(
                "refine_residual=True needs the compressed store "
                "(raw_store=False); the raw tier's f32 rows are already "
                "exact refine sources")
        self.config = config
        self.store = VectorStore(capacity, dim, raw=config.raw_store,
                                 device=device,
                                 residual=config.refine_residual)
        self.device = self.store.device
        self.codes = torch.zeros((self.store.capacity, sub), dtype=torch.uint8,
                                 device=self.device)
        # bumped by every write of codes or codebooks (keys the ADC tables)
        self._codes_version = 0
        self.codebooks: Optional[torch.Tensor] = None  # [S, K, sub_dim]
        self.perm: Optional[torch.Tensor] = None  # PQ space = vectors[:, perm]
        self.trained = False
        self.seed = 42
        # the table scan of ``adc`` reduces a block by a one-hot product
        # (bf16 tables, the reference's choice) rather than a gather
        self.adc_impl = "onehot"
        # the graph (exact-distance build), only under use_graph: its
        # [L, cap, M] int32 adjacency is 6.4 GB at 10M rows
        self._max_level = max(1, int(np.log(max(self.store.capacity, 2))
                                     / np.log(max(config.m, 2))) + 1)
        if config.use_graph:
            self.graph = hg.init_graph(self.store.capacity, config.m,
                                       self._max_level, self.device)
        self._level_counter = 0
        # defer insert policy: trained graph-mode adds are buffered here
        # and searches fold them into the exact refine
        self._init_pending(self.store.capacity)
        # PCA proxy (search_mode="pca", proxy_dims > 0): mean / basis fitted
        # at training, proxy rows [cap, p] bf16 written by every encode
        self.pca_mean: Optional[torch.Tensor] = None
        self.pca_basis: Optional[torch.Tensor] = None
        self.proxy: Optional[torch.Tensor] = None
        # the coarse quantizer (config.nlist > 0): centroids [nlist, dim] in
        # probe space, and each slot's nearest centroid on the host (-1 for
        # dead slots, and for rows train() places under scan_ivf, whose
        # layout takes its own top-8 choices), as the reference keeps them
        self.coarse_centroids: Optional[torch.Tensor] = None
        self.coarse_assign = np.full(self.store.capacity, -1, np.int32)
        # one lock: no two searches refresh a cache at once; an RLock, as
        # the scan_ivf layout reads the scan shadows under it
        lock = threading.RLock()
        shadow = ("whole", "incremental")
        refine = ("bf16_refine" if config.refine_store == "bf16"
                  else "int8_refine",) * 2
        dev = self.device
        self._caches = _Caches(
            scan8=DerivedCache(lock, shadow, dev),
            scan8g=DerivedCache(lock, shadow, dev),
            scan16=DerivedCache(lock, shadow, dev),
            refine=DerivedCache(lock, refine, dev),
            ivf=DerivedCache(lock, ("ivf_layout", "ivf_overlay"), dev),
            scan8p=DerivedCache(lock, shadow),
            fast=DerivedCache(lock, ("fast_tables",) * 2, dev),
            members=DerivedCache(lock), proxy_norms=DerivedCache(lock))
        # searches of at most 8 queries replayed from CUDA graphs
        self._q8 = q8graph.for_device(self.device)

    # ------------------------------------------------------------- mutation
    def _note_row_mutation(self, slots: np.ndarray, caches=None) -> None:
        """Record store rows written or removed in the dirty records of
        ``caches`` (by default the row-keyed ones); past max(8192, capacity
        / 8) rows a record is void (a rebuild)."""
        arr = np.asarray(slots, np.int64).ravel()
        limit = max(8192, self.store.capacity // 8)
        for cache in self._caches[:5] if caches is None else caches:
            cache.note(arr, limit)

    def _note_store_rewrite(self) -> None:
        """An untracked rewrite of the whole store: every cache is void."""
        for cache in self._caches:
            cache.void()

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
            if self.coarse_centroids is not None:
                self._assign_coarse(slots_np)
            if self.config.use_graph:
                if self.config.insert_policy == "defer":
                    self._pend_slots(slots_np.astype(np.int32))
                else:
                    self._graph_insert(slots_np.astype(np.int32))
        return accepted

    def _sample_levels(self, n: int) -> np.ndarray:
        self._level_counter += 1
        return sample_graph_levels(self.seed, self._level_counter - 1, n,
                                   self.config.m, self._max_level)

    def bulk_load(self, ids: Sequence[int], vectors) -> list[int]:
        """Bulk ingest of an [n, dim] corpus (ideally already on the
        index's device) into an empty index, then train + encode."""
        accepted = self.store.bulk_load(ids, vectors)
        self._note_store_rewrite()
        self._q8.clear()
        if accepted:
            self.train()
        return accepted

    def bulk_load_stream(self, chunks) -> int:
        """Streamed bulk ingest: the raw corpus never exists in full.

        ``chunks`` yields ``(ids, vectors)`` pairs (ids [c] ints, vectors
        [c, dim] f32, ideally on the index's device).  Rows land in
        contiguous slots in arrival order.  The first chunk trains the PQ
        codebooks and must hold >= ``num_centroids`` rows; each chunk is
        then written to the store (raw, or int8-packed with exact norms and
        the residual level) and encoded, in place, so at most one f32 chunk
        is resident beside the index.  Each chunk is validated before any
        of it is written; whatever was written stays consistent if a later
        chunk raises.  Returns the number of rows ingested.
        """
        if self.store.size() > 0:
            raise ValueError("bulk_load_stream requires an empty index")
        self._note_store_rewrite()
        self._q8.clear()
        if self.config.use_graph:
            raise ValueError(
                "bulk_load_stream does not build the HNSW graph; "
                "use use_graph=False (scan/adc/pca modes) or bulk_load")
        cap = self.store.capacity
        start = 0
        id_map = self.store._id_to_slot
        try:
            for ids, vecs in chunks:
                ids_np = np.asarray(ids, np.int32)
                vecs = torch.as_tensor(vecs, dtype=torch.float32).to(
                    self.device)
                c = vecs.shape[0]
                # validate BEFORE writing anything of this chunk
                if vecs.ndim != 2 or vecs.shape[1] != self.dim:
                    raise ValueError(
                        f"expected [*, {self.dim}] chunk, got "
                        f"{tuple(vecs.shape)}")
                if len(ids_np) != c:
                    raise ValueError("ids/vectors length mismatch in chunk")
                if start + c > cap:
                    raise ValueError(
                        f"stream exceeds capacity: {start + c} > {cap}")
                if np.any(ids_np < 0):
                    raise ValueError("negative ids in bulk_load_stream")
                if np.unique(ids_np).size != c:
                    raise ValueError("duplicate ids within a chunk")
                if any(int(v) in id_map for v in ids_np):
                    raise ValueError("duplicate ids across chunks")
                if not self.trained:
                    self._fit_quantizers(vecs)
                self.store.write_range(start, ids_np, vecs)
                self.codes[start:start + c] = adc.pq_encode(
                    self._pq_space(vecs), self.codebooks)
                if self.proxy is not None:
                    self.proxy[start:start + c] = self._project(vecs)
                if self.coarse_centroids is not None:
                    self.coarse_assign[start:start + c] = self._nearest_coarse(
                        vecs)
                start += c
        finally:
            # the freelist reflects whatever was written, even on a raise
            self.store._free = list(range(cap - 1, start - 1, -1))
            self._codes_version += 1
            self._caches.proxy_norms.void()
            self._caches.members.void()
        return start

    def _fit_quantizers(self, data: torch.Tensor) -> None:
        """Fit the PQ codebooks (and the dimension permutation) and, under
        ``pca``, the proxy basis on a training sample of the first streamed
        chunk, and the coarse
        quantizer on the chunk itself when ``nlist > 0`` (under scan_ivf
        ``nlist = 0`` is sized from the store capacity: the final live
        count is unknown mid-stream); encodes nothing."""
        n = data.shape[0]
        if n < self.config.num_centroids:
            raise ValueError(
                f"first chunk must hold >= {self.config.num_centroids} "
                f"training rows, got {n}")
        with span("ingest.train", wait=self.device):
            sample = data
            if n > self.config.training_samples:
                rng = np.random.default_rng(self.seed)
                pick = np.sort(rng.choice(n, self.config.training_samples,
                                          replace=False))
                sample = data[torch.as_tensor(pick, device=data.device)]
            self._fit_codebooks(sample)
            self._fit_proxy(sample)
            if self.config.nlist == 0 \
                    and self.config.search_mode == "scan_ivf":
                self.config.nlist = ivf_scan.auto_ivf_geometry(
                    self.store.capacity, winners=self.config.ivf_winners)[0]
            if self.config.nlist > 0:
                nlist = min(self.config.nlist, max(1, n // 8))
                full = (normalize_rows(data) if self.metric == "cosine"
                        else data)
                if n > max(256 * nlist, 262144):
                    rng = np.random.default_rng(self.seed + 7)
                    pick = np.sort(rng.choice(n, max(256 * nlist, 262144),
                                              replace=False))
                    full = full[torch.as_tensor(pick, device=data.device)]
                self._set_coarse(self._coarse_kmeans(full, nlist))

    def _fit_codebooks(self, data: torch.Tensor) -> None:
        """Per-subspace k-means++ on training rows (normalized under
        cosine, after the variance-balancing permutation)."""
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
        self._codes_version += 1
        self._caches.fast.void()  # a refresh never mixes two codebooks

    def _fit_proxy(self, sample: torch.Tensor) -> None:
        """Under ``search_mode="pca"`` with ``proxy_dims > 0``: fit the PCA
        basis on the (unpermuted) training rows, normalized under cosine
        (the proxy space holds the unit sphere), on the host in numpy as
        the reference does, and allocate the proxy.  Other modes pay
        neither the projection of every encode nor the checkpoint bytes."""
        if self.config.proxy_dims <= 0 or self.config.search_mode != "pca":
            return
        raw = sample.cpu().numpy()
        if self.metric == "cosine":
            raw = raw / np.maximum(
                np.linalg.norm(raw, axis=1, keepdims=True), 1e-12)
        mu, basis = pca.pca_fit(raw, min(self.config.proxy_dims, self.dim))
        self.pca_mean = torch.as_tensor(mu, device=self.device)
        self.pca_basis = torch.as_tensor(basis, device=self.device)
        self.proxy = torch.zeros((self.store.capacity, basis.shape[1]),
                                 dtype=torch.bfloat16, device=self.device)
        self._caches.proxy_norms.void()

    def _project(self, vecs: torch.Tensor) -> torch.Tensor:
        """Proxy rows of store rows (normalized first under cosine)."""
        if self.metric == "cosine":
            vecs = normalize_rows(vecs)
        return pca.project_rows(vecs, self.pca_mean, self.pca_basis)

    def remove(self, vec_id: int) -> bool:
        slot = self.store.remove(vec_id)
        if slot is None:
            return False
        self._note_row_mutation(np.asarray([slot]))
        self.coarse_assign[slot] = -1
        self._caches.members.void()
        if not self.config.use_graph or self._unpend_slot(slot):
            return True  # no graph, or the row never reached it
        was_entry = self.graph.entry == slot
        hg.unlink_slot(self.graph, slot)
        if was_entry:
            fix_entry_after_unlink(self.graph, self.store.state.valid)
        return True

    # --------------------------------------------------------------- train
    def train(self) -> bool:
        """Per-subspace k-means++ PQ training on up to ``training_samples``
        live rows (the same host-side sample as the reference), then encode
        every live row.  With ``nlist > 0`` (under scan_ivf ``nlist = 0`` is
        auto-sized from the live rows, and sticks) the coarse quantizer
        trains on up to max(256 nlist, 262144) live rows (sampled with seed
        + 7) and, under any other mode, assigns every live row."""
        if self.store.size() < self.config.num_centroids:
            return False
        with span("ingest.train", wait=self.device):
            live = np.flatnonzero(self.store.state.valid.cpu().numpy())
            sample = live
            if sample.size > self.config.training_samples:
                rng = np.random.default_rng(self.seed)
                sample = rng.choice(sample, self.config.training_samples,
                                    replace=False)
            rows = self.store.rows(np.sort(sample))
            self._fit_codebooks(rows)
            self._fit_proxy(rows)
            del rows
        self._encode_slots(live)
        if self.config.nlist == 0 and self.config.search_mode == "scan_ivf":
            self.config.nlist = ivf_scan.auto_ivf_geometry(
                live.size, winners=self.config.ivf_winners)[0]
        if self.config.nlist > 0:
            nlist = min(self.config.nlist, max(1, live.size // 8))
            rows = live
            if rows.size > max(256 * nlist, 262144):
                rng = np.random.default_rng(self.seed + 7)
                rows = np.sort(rng.choice(rows, max(256 * nlist, 262144),
                                          replace=False))
            with span("ingest.train", wait=self.device):
                full = self.store.rows(rows)
                if self.metric == "cosine":
                    full = normalize_rows(full)  # the quantizer on the sphere
                self._set_coarse(self._coarse_kmeans(full, nlist))
            if self.config.search_mode != "scan_ivf":
                # scan_ivf places rows by its own top-8 choices pass
                self._assign_coarse(live)
        if self.config.use_graph:
            self._rebuild_graph()
        return True

    def _coarse_kmeans(self, full: torch.Tensor, nlist: int) -> torch.Tensor:
        """The coarse quantizer: random init (generator seed + 1) and
        Lloyd, the dense :func:`kmeans_fit` while rows * nlist <= 2^27, past
        that :func:`kmeans_fit_blocked` over the sample trimmed to a whole
        number of blocks (a few training rows, never corpus rows)."""
        rows = full.shape[0]
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        iters = self.config.training_iterations
        if rows * nlist > (1 << 27):
            chunk = max(128, min(rows, (1 << 26) // nlist) // 128 * 128)
            return kmeans_fit_blocked(gen, full[:rows // chunk * chunk],
                                      k=nlist, iters=iters, chunk=chunk)
        return kmeans_fit(gen, full[None], k=nlist, iters=iters,
                          plus_plus=False)[0][0]

    def _set_coarse(self, centroids: Optional[torch.Tensor]) -> None:
        """New coarse centroids: the scan_ivf layout built on the old ones
        is dropped."""
        self.coarse_centroids = centroids
        self._caches.ivf.void()
        self._caches.members.void()

    def _nearest_coarse(self, vecs: torch.Tensor) -> np.ndarray:
        """Each row's nearest coarse centroid (rows normalized under
        cosine), on the host."""
        if self.metric == "cosine":
            vecs = normalize_rows(vecs)
        d = pairwise_sq_l2(vecs, self.coarse_centroids)
        return torch.argmin(d, dim=1).to(torch.int32).cpu().numpy()

    def _assign_coarse(self, slots: np.ndarray) -> None:
        """coarse_assign of the given slots, in row blocks (no [N, d] f32
        block of the compressed store exists whole)."""
        slots = np.asarray(slots, np.int64)
        step = max(1, COARSE_BLOCK_ELEMS // self.coarse_centroids.shape[0])
        for s in range(0, slots.size, step):
            sl = slots[s:s + step]
            self.coarse_assign[sl] = self._nearest_coarse(self.store.rows(sl))
        self._caches.members.void()

    def _member_table(self) -> tuple:
        """(members [nlist, L], L, overflow) of the pruned ``adc`` scan:
        each cluster keeps at most a quota of 4x the mean size, members
        past it spill into the shared overflow list every query scans
        (``core/member_table``); rebuilt on the host after the assignment
        or the live set moved (which void it)."""
        return self._caches.members.get(True, self._build_member_table)

    def _build_member_table(self) -> tuple:
        table, _, over = build_member_table(
            self.coarse_assign, self.store.state.valid.cpu().numpy(),
            int(self.coarse_centroids.shape[0]), quota_mult=4.0, align=32)
        table = torch.as_tensor(table, device=self.device)
        return table, table.shape[1], torch.as_tensor(over, device=self.device)

    def build(self) -> None:
        """Train if needed, else re-encode every live row and, with the
        graph, rebuild it."""
        self._q8.clear()
        if not self.trained:
            self.train()
        else:
            self._encode_slots(
                np.flatnonzero(self.store.state.valid.cpu().numpy()))
            if self.config.use_graph:
                self._rebuild_graph()

    def _encode_slots(self, slots: np.ndarray) -> None:
        """PQ-encode the given slots (and project them into the proxy), in
        chunks whose [S, rows, K] distance block fits
        ``adc.ENCODE_CHUNK_BYTES`` (the compressed store dequantizes only
        one chunk of rows at a time)."""
        if self.codebooks is None or len(slots) == 0:
            return
        s, k, _ = self.codebooks.shape
        chunk = max(1, adc.ENCODE_CHUNK_BYTES // (4 * s * k))
        slots_t = torch.as_tensor(np.asarray(slots), dtype=torch.long,
                                  device=self.device)
        for start in range(0, slots_t.numel(), chunk):
            sl = slots_t[start:start + chunk]
            rows = self.store.rows(sl)
            self.codes[sl] = adc.pq_encode(self._pq_space(rows),
                                           self.codebooks)
            if self.proxy is not None:
                self.proxy[sl] = self._project(rows)
        if self.proxy is not None:
            self._caches.proxy_norms.void()
        self._codes_version += 1
        self._note_row_mutation(slots, (self._caches.fast,))

    def _pq_space(self, vecs: torch.Tensor) -> torch.Tensor:
        """Vectors as the quantizer sees them: normalized under cosine,
        then dimension-permuted."""
        if self.metric == "cosine":
            vecs = normalize_rows(vecs)
        if self.perm is not None:
            vecs = vecs[:, self.perm]
        return vecs

    # ------------------------------------------------------- derived caches
    def _scan8_shadow(self) -> tuple:
        """(base8, off, sc, center_vec, aux) for scan_pallas_int8 on a raw
        store, current with the store.  Rows written since the last build
        are requantized against the cached centering (O(dirty * d)); an
        unknown or over-threshold rewrite rebuilds it whole."""
        return self._caches.scan8.get(self.store.version, self._build_scan8,
                                      self._refresh_scan8)

    def _build_scan8(self) -> tuple:
        st = self.store.state
        return _build_scan8_shadow(st.vectors, st.norms, st.valid,
                                   self.metric, SHADOW_PAD_ROWS)

    def _refresh_scan8(self, shadow: tuple, slots: torch.Tensor) -> tuple:
        st = self.store.state
        _update_scan8_shadow(*shadow[:3], st.vectors, st.norms, st.valid,
                             slots, *shadow[3:], self.metric)
        return shadow

    def _scan8g_shadow(self) -> tuple:
        """(base8, off, sv, sgn, center_vec, aux, clipped) for
        scan_pallas_int8 with ``int8_epilogue="global"`` on a raw store,
        current with the store.  Rows written since the last build are
        requantized against the cached centering AND the cached global
        scale ``sv`` (a wider row clips at +-127); once the live rows
        clipped since the build pass max(64, 1% of the live rows), or on an
        unknown rewrite, the shadow is rebuilt whole, which refreshes
        ``sv``."""
        return self._caches.scan8g.get(self.store.version,
                                       self._build_scan8g,
                                       self._refresh_scan8g)

    def _build_scan8g(self) -> tuple:
        st = self.store.state
        return _build_scan8g_shadow(st.vectors, st.norms, st.valid,
                                    self.metric, SHADOW_PAD_ROWS) + (0,)

    def _refresh_scan8g(self, shadow: tuple, slots: torch.Tensor):
        base8, off, sv, _, cvec, aux, clipped = shadow
        st = self.store.state
        clipped += _update_scan8g_shadow(base8, off, st.vectors, st.norms,
                                         st.valid, slots, cvec, aux, sv,
                                         self.metric)
        if clipped > max(64, 0.01 * self.store.size()):
            return None
        return shadow[:6] + (clipped,)

    def _scan16_shadow(self) -> tuple:
        """(base16, off, sc, center_vec, aux) for scan_pallas on a raw
        store, current with the store: rows written since the last build
        are reconditioned against the cached centering, an unknown or
        over-threshold rewrite rebuilds it whole."""
        return self._caches.scan16.get(self.store.version,
                                       self._build_scan16,
                                       self._refresh_scan16)

    def _build_scan16(self) -> tuple:
        st = self.store.state
        return _build_scan16_shadow(st.vectors, st.norms, st.valid,
                                    self.metric, SHADOW_PAD_ROWS)

    def _refresh_scan16(self, shadow: tuple, slots: torch.Tensor) -> tuple:
        st = self.store.state
        _update_scan16_shadow(*shadow[:3], st.vectors, st.norms, st.valid,
                              slots, *shadow[3:], self.metric)
        return shadow

    def _scan8p_shadow(self) -> tuple:
        """(off, sc, center_vec) for scan_pallas_int8 on a compressed
        store: O(N) conditioning vectors (the kernel reads the store's own
        packed rows), rebuilt whenever the store's version moved."""
        return self._caches.scan8p.get(self.store.version,
                                       self._build_scan8p)

    def _build_scan8p(self) -> tuple:
        st = self.store.state
        return _build_scan8p_shadow(st.packed, st.scales, st.norms, st.valid,
                                    self.metric)

    def _packed_refine_store(self) -> Optional[torch.Tensor]:
        """The bf16 refine store of a raw store with refine_store="bf16",
        current with the store (dirty rows repacked only), else None."""
        if self.config.refine_store != "bf16" or not self.store.raw:
            return None
        return self._refine_rows()[0]

    def _int8_refine_store(self) -> Optional[tuple]:
        """(packed [cap, d/4] int32, scales [cap]) int8 refine rows, or
        None: the compressed store's own rows, or a packed shadow of a raw
        store with refine_store="int8" (dirty rows repacked only)."""
        if not self.store.raw:
            return self.store.state.packed, self.store.state.scales
        if self.config.refine_store != "int8":
            return None
        return self._refine_rows()

    def _refine_rows(self) -> tuple:
        """The raw store packed a row at a time for the refine (a tuple of
        [N, ...] tensors: bf16 rows, or int8 words and scales), kept
        current: the rows written since are repacked in place,
        bit-identical to a whole rebuild (span note ``bf16_refine`` or
        ``int8_refine``)."""
        return self._caches.refine.get(self.store.version, self._pack_refine,
                                       self._repack_refine)

    def _pack_refine(self, slots: Optional[torch.Tensor] = None) -> tuple:
        vecs = self.store.state.vectors
        rows = vecs if slots is None else vecs[slots]
        if self.config.refine_store == "bf16":
            return (pack_bf16_rows(rows),)
        return pack_int8_rows(rows)

    def _repack_refine(self, packed: tuple, slots: torch.Tensor) -> tuple:
        for dst, src in zip(packed, self._pack_refine(slots)):
            dst[slots] = src
        return packed

    def _int8_refine_args(self, i8: Optional[tuple], resid, rscales) -> dict:
        """The int8 refine keywords of the pool searches from an
        :meth:`_int8_refine_store` pair (None: no int8 refine) and the
        residual level."""
        return dict(
            int8_base=None if i8 is None else i8[0],
            int8_scales=None if i8 is None else i8[1],
            int8_norms=None if i8 is None else self.store.state.norms,
            int8_resid=resid, int8_rscales=rscales)

    def _int8_resid_store(self) -> tuple:
        """(resid, rscales) of a compressed store with the residual level,
        else (None, None)."""
        st = self.store.state
        if self.store.raw or st.resid is None:
            return None, None
        return st.resid, st.rscales

    def _fast_tables(self) -> tuple:
        """(codes_t [S, cap] uint8, cbt [S*sd, K], reconstruction norms
        [cap]) for adc_fast, current with the codes (keyed on
        ``_codes_version``; new codebooks void them).  Re-encoded slots are
        refreshed in place (_update_fast_tables); new codebooks or an
        unknown rewrite rebuild them (:func:`_build_fast_tables`).  A build
        or refresh is the span ``index.shadow`` noted ``fast_tables``."""
        return self._caches.fast.get(self._codes_version,
                                     self._build_fast_tables,
                                     self._refresh_fast_tables)

    def _build_fast_tables(self) -> tuple:
        return _build_fast_tables(self.codes, self.codebooks)

    def _refresh_fast_tables(self, tables: tuple, slots: torch.Tensor
                             ) -> tuple:
        _update_fast_tables(tables[0], tables[2], self.codes, self.codebooks,
                            slots)
        return tables

    # ------------------------------------------------------ scan_ivf layout
    #: rows written since the last layout that a search scores exactly
    #: beside the pool; past it the next search lays the grid out again
    _IVF_OVERLAY_MAX = 1024

    def _ivf_layout(self) -> "_IvfLayout":
        """The balanced cluster-major layout for scan_ivf, current with the
        store.  Keyed on ``store.version`` (the reference keys it on array
        identity, which in-place writes never change).  Rows written or
        removed since the build are handled without moving grid rows: their
        positions get a +inf offset and their slots join the exact overlay,
        O(dirty) per search.  Past ``_IVF_OVERLAY_MAX`` overlay rows, or
        after an untracked rewrite, the layout is built again.  The int8
        rows it gathers are made current first, so that their build's span
        stands beside the layout's and not inside it."""
        (self._scan8_shadow if self.store.raw else self._scan8p_shadow)()
        return self._caches.ivf.get(self.store.version,
                                    self._build_ivf_layout,
                                    self._refresh_ivf_layout)

    def _refresh_ivf_layout(self, lay: "_IvfLayout", slots: torch.Tensor
                            ) -> Optional["_IvfLayout"]:
        overlay = np.union1d(lay.overlay, slots.cpu().numpy())
        if overlay.size > self._IVF_OVERLAY_MAX:
            return None
        pos = lay.slot2pos[slots]
        lay.off_cm[pos[pos >= 0].long()] = float("inf")
        lay.slot2pos[slots] = -1
        # -1 padded to a power of two: a bounded set of shapes, as there
        padded = np.full(pow2(overlay.size), -1, np.int64)
        padded[:overlay.size] = overlay
        return lay._replace(overlay=overlay, overlay_dev=torch.as_tensor(
            padded, device=self.device))

    def _build_ivf_layout(self) -> "_IvfLayout":
        """Every live row's top-8 clusters (``ivf_scan.coarse_choices``),
        the balanced placement (``ivf_scan.balanced_layout_dev``) at cap =
        1.3x the mean fill, rounded to 128 and capped by the pool width, and
        the cluster-major gather of the int8 rows with their selection
        offsets and scales: the raw store's from its per-row int8 shadow
        (:meth:`_scan8_shadow`), the compressed store's from its own packed
        rows (:meth:`_scan8p_shadow`).  All on the device."""
        st = self.store.state
        cents = self.coarse_centroids
        nlist = cents.shape[0]
        n_live = self.store.size()
        winners = max(1, self.config.ivf_winners)
        cap_max = (IVF_PW // winners) * LANES
        cap = min(max(-(-int(n_live / nlist * 1.3) // LANES) * LANES, LANES),
                  cap_max)
        if nlist * cap < n_live:
            raise ValueError(
                f"scan_ivf: nlist={nlist} cannot hold {n_live} rows at the "
                f"kernel's cluster capacity limit {cap_max} (ivf_winners="
                f"{winners}); retrain with a larger nlist (0 auto-sizes) or "
                "fewer ivf_winners")
        rows = st.capacity
        chunk = max(LANES, COARSE_BLOCK_ELEMS // nlist)
        if self.store.raw:
            base8, off, sc, cvec, _ = self._scan8_shadow()
            packed_src = base8[:rows].view(torch.int32)
            choices = ivf_scan.coarse_choices(st.vectors, None, cents,
                                              self.metric, 8, chunk)
        else:
            off, sc, cvec = self._scan8p_shadow()
            packed_src = st.packed
            choices = ivf_scan.coarse_choices(st.packed, st.scales, cents,
                                              self.metric, 8, chunk)
        pos2slot, slot2pos, spilled = ivf_scan.balanced_layout_dev(
            choices, st.valid, nlist, cap)
        del choices
        cm, off_cm, sc_cm = _gather_ivf_cm(packed_src, off[:rows], sc[:rows],
                                           pos2slot)
        return _IvfLayout(cents, cm, off_cm, sc_cm, cvec, pos2slot, slot2pos,
                          cap, int(spilled), np.empty(0, np.int64), None)

    # ------------------------------------------------------------- graph ops
    def _graph_insert(self, slots: np.ndarray) -> None:
        """Connect store slots with exact distances: the exact-kNN bulk
        build into an empty graph (at least 4 m slots), else batched
        insertion rounds of 64.  (Also the mixin's hook for a flush into an
        empty graph.)"""
        levels = self._sample_levels(len(slots))
        st = self.store.state
        live = self.store.size() - len(slots)
        if self.graph.entry < 0 and len(slots) >= 4 * self.config.m:
            hg.bulk_build(self.graph, st.vectors, st.norms, slots, levels,
                          m=self.config.m, heuristic=True)
            return
        if self.graph.entry < 0:
            hg.seed_first(self.graph, int(slots[0]), int(levels[0]))
            live = max(live, 1)
        hg.host_insert_stream(
            self.graph, st.vectors, st.norms, slots, levels, batch=64,
            live_before=live, efc=self.config.ef_construction, expand=4,
            heuristic=True)

    def _rebuild_graph(self) -> None:
        """A fresh graph over every live row, in id order."""
        st = self.store.state
        ids_np = st.ids.cpu().numpy()
        live = np.flatnonzero(st.valid.cpu().numpy())
        order = live[np.argsort(ids_np[live], kind="stable")]
        self.graph = hg.init_graph(self.store.capacity, self.config.m,
                                   self._max_level, self.device)
        self._clear_pending()  # the rebuild connects everything
        if order.size:
            self._graph_insert(order.astype(np.int32))

    # --------------------------------------------------------------- search
    def _f32_scan_block(self, capacity: int, q_n: int) -> int:
        """Block length of the blocked exact scan: few big blocks, the
        [Q, block] f32 buffer capped at ~1 GB."""
        block = max(32768, min(1 << 20, (1 << 28) // max(q_n, 1)))
        return min(block - block % 128, max(capacity, 128))

    def _scan_chunk(self, capacity: int, q_n: int) -> int:
        """Chunk length of the streamed adc_fast scan: the smallest chunk
        (131,072) for Q <= 64, else few big chunks with the [Q, chunk] f32
        block <= 2 GB and the [d, chunk] bf16 reconstruction <= 512 MB (the
        reference's rule)."""
        if q_n <= 64:
            return min(131072, max(capacity, 128))
        by_q = (1 << 29) // max(q_n, 1)
        by_decode = (1 << 28) // max(self.dim, 1)
        chunk = max(131072, min(1 << 20, by_q, by_decode))
        return min(chunk - chunk % 128, max(capacity, 128))

    def search_batch(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        st = self.store.state
        raw = self.store.raw
        n_live = self.store.size()
        k_eff = min(k, st.capacity)
        k_pad = min(pow2(k_eff), st.capacity)
        resid, rscales = self._int8_resid_store()
        if self._q8.capturer is not None:
            queries = torch.as_tensor(queries, dtype=torch.float32)
            if queries.ndim == 2 and queries.shape[1] == self.dim \
                    and 0 < queries.shape[0] <= q8graph.Q_ROWS:
                got = self._q8_search(queries, k, k_eff, k_pad, n_live)
                if got is not None:
                    return got
        with span("index.copy_in"):
            padded, q_n = pad_queries_pow2(
                as_queries(queries, self.dim, self.device))

        if not self.trained or n_live <= k:
            # exact fallback until trained, and whenever every row is wanted
            with span("index.scan"):
                if raw:
                    dists, slots = blocked_knn(
                        padded, st.vectors, st.valid, k_pad,
                        metric=self.metric, b_norms=st.norms,
                        block_n=min(8192, st.capacity))
                else:
                    dists, slots = blocked_knn_int8(
                        padded, st.packed, st.scales, st.valid, k_pad,
                        metric=self.metric, b_norms=st.norms,
                        block_n=min(262144, st.capacity), resid=resid,
                        rscales=rscales)
            return to_host_results(q_n, k, k_eff, slots, st.ids, dists)

        mode = self.resolve_mode(n_live)
        if not raw and mode in RAW_ONLY_MODES:
            raise ValueError(f"search_mode={mode!r} needs the raw f32 store "
                             "(raw_store=False)")
        program = self._mode_program(mode, k_pad, padded.shape[0])
        if program is not None:
            dists, ext = program.run(padded)
        else:
            search = self._MODE_SEARCH.get(mode)
            if search is None:
                # a mode without a search of its own ("graph", "adc"): the
                # graph where one is built, else the adc scan (the reference)
                search = (HnswPqIndex._graph_search
                          if self.config.use_graph and self.graph.entry >= 0
                          else HnswPqIndex._adc)
            dists, ext = search(self, padded, k_pad, resid, rscales)
        return to_host_results(q_n, k, k_eff, ext, None, dists)

    def _pool_shape(self, k_pad: int, rows: int) -> tuple:
        """(pool, w) of a pool mode over ``rows`` rows: buckets of w (at
        most SHADOW_PAD_ROWS of a raw store's shadow, else the preserved
        width), the best min(max(4 k_pad, 64), w) re-ranked."""
        w = (min(SHADOW_PAD_ROWS, rows) if self.store.raw
             else preserved_pool_width(rows))
        return min(max(4 * k_pad, 64), w), w

    def _mode_program(self, mode: str, k_pad: int, q_pad: int
                      ) -> Optional[q8graph.Program]:
        """The program of ``q_pad`` padded queries under the modes the
        padded-8 graph captures, on the raw store: ``scan_exact``, and
        ``scan_pallas_int8`` with the per-row epilogue (B2, then the exact
        re-rank); None for every other mode.  The shadow's count of whole
        builds is part of the key: a rebuilt shadow is captured anew."""
        if not self.store.raw:
            return None
        st = self.store.state
        store = (st.vectors, st.norms, st.valid, st.ids)
        if mode == "scan_exact":
            block = self._f32_scan_block(st.capacity, q_pad)
            return q8graph.Program(
                lambda q: exact_scan_search(q, *store, k_pad, self.metric,
                                            block),
                (mode, k_pad, block, self.metric), store)
        if mode == "scan_pallas_int8" \
                and self.config.int8_epilogue != "global":
            base8, off, sc, cvec, _ = self._scan8_shadow()
            pool, w = self._pool_shape(k_pad, base8.shape[0])
            return q8graph.Program(
                lambda q: pallas_scan8_refine(
                    q, st.vectors, base8, off, sc, cvec, st.ids, k_pad,
                    self.metric, pool=pool, w=w),
                (mode, k_pad, pool, w, self.metric,
                 self._caches.scan8.builds),
                store + (base8, off, sc, cvec))
        return None

    def _q8_search(self, queries: torch.Tensor, k: int, k_eff: int,
                   k_pad: int, n_live: int):
        """Host answers of at most 8 queries by a graph replay
        (``index/q8graph``), or None where the call runs eagerly: the
        exact fallback, a mode outside the captured set, or the first call
        under its key (counted in ``q8graph.eager``)."""
        if self.trained and n_live > k:
            program = self._mode_program(self.resolve_mode(n_live), k_pad,
                                         q8graph.Q_ROWS)
            if program is not None:
                got = self._q8.search(program, queries, k, k_eff)
                if got is not None:
                    return got
        GLOBAL.bump("q8graph.eager")
        return None

    def _refine_width(self, k_pad: int) -> int:
        """Candidates the ``adc`` and graph modes re-rank."""
        return min(max(pow2(self.config.refine_k), k_pad),
                   self.store.capacity)

    def _pca(self, padded, k_pad, resid, rscales):
        """pca on either store: chunked past 6 GB of [Q, N] proxy
        distances (``ops/pca``), in chunks of :meth:`_scan_chunk` rows."""
        if self.proxy is None:
            raise ValueError(
                "search_mode='pca' needs a fitted proxy: set proxy_dims > 0 "
                "and search_mode='pca' before training (or retrain/build())")
        st = self.store.state
        proxy_norms = self._caches.proxy_norms.get(True,
                                                   self._build_proxy_norms)
        return pca.pca_proxy_search(
            padded, self.pca_mean, self.pca_basis, self.proxy, proxy_norms,
            st.valid, st.vectors if self.store.raw else None, st.ids,
            k=k_pad, select_r=max(self.config.pca_r, k_pad),
            metric=self.metric, packed_base=self._packed_refine_store(),
            block_n=self._scan_chunk(st.capacity, padded.shape[0]),
            **self._int8_refine_args(self._int8_refine_store(), resid,
                                     rscales))

    def _build_proxy_norms(self) -> torch.Tensor:
        return pca.rows_sq_norms(self.proxy)

    def _graph_search(self, padded, k_pad, resid=None, rscales=None):
        """Graph mode: ADC-distance traversal with a beam of
        max(pow2(ef_search), refine), the first ``refine`` of its pool
        re-ranked exactly; pending rows are scored by one [Q, P] product
        beside the refine (never broadcast into its [Q, R, d] gather)."""
        st = self.store.state
        refine = self._refine_width(k_pad)
        tables = adc.build_distance_tables(self._pq_space(padded),
                                           self.codebooks)
        ef = min(max(pow2(self.config.ef_search), refine), st.capacity)
        _, cand = hnsw_pq_search(self.graph, self.codes, tables, st.valid, ef)
        cand = cand[:, :refine]
        if self._pending_count > 0:
            dists, slots = _graph_refine_pending(
                padded, st.vectors, st.valid, cand, self._pending_padded(),
                k_pad, self.metric)
        else:
            dists, slots = blocked_rerank(padded, st.vectors, cand, k_pad,
                                          self.metric)
        return dists, slot_ids(slots, st.ids)

    def _adc(self, padded, k_pad, resid, rscales):
        """adc on either store: the exhaustive table scan, or the pruned
        one when a coarse quantizer is trained."""
        st = self.store.state
        # a raw store re-ranks against its f32 rows, whatever refine_store
        refine_args = self._int8_refine_args(
            None if self.store.raw else self._int8_refine_store(), resid,
            rscales)
        base = st.vectors if self.store.raw else None
        refine = self._refine_width(k_pad)
        if self.coarse_centroids is not None:
            members, max_len, overflow = self._member_table()
            nprobe = min(self.config.nprobe, self.coarse_centroids.shape[0])
            return flagship_search_pruned(
                padded, self.codebooks, self.codes, st.valid, base, st.ids,
                self.coarse_centroids, members, overflow, k_pad, refine,
                nprobe, max_len, self.metric, self.perm, **refine_args)
        return flagship_search(
            padded, self.codebooks, self.codes, st.valid, base, st.ids,
            k_pad, refine, self.adc_impl, min(4096, st.capacity),
            self.metric, self.perm, **refine_args)

    def resolve_mode(self, n_live: int) -> str:
        """The scan a trained index runs for ``search_mode`` at ``n_live``
        live rows: auto is adc_fast on a compressed store, else
        :func:`_auto_scan_mode`."""
        mode = self.config.search_mode
        if mode != "auto":
            return mode
        if not self.store.raw:
            return "adc_fast"
        return _auto_scan_mode(self.config.use_graph, n_live)

    def ivf_search_shape(self, q_pad: int, k_pad: int) -> tuple:
        """(nprobe, p_cap, pool) of a scan_ivf search of ``q_pad`` padded
        queries for ``k_pad`` results: nprobe clamped to [1, nlist]; the
        prober tile p_cap = ivf_p_cap or pow2(4 Q nprobe / nlist) in [32,
        512] (~4x the mean probers of a cluster); the candidate pool =
        ivf_pool or min(max(4 k, 256), nprobe * 128)."""
        nlist = self.coarse_centroids.shape[0]
        nprobe = max(1, min(self.config.nprobe, nlist))
        p_cap = self.config.ivf_p_cap or int(np.clip(
            pow2(max(1, 4 * q_pad * nprobe // nlist)), 32, 512))
        pool = self.config.ivf_pool or min(max(4 * k_pad, 256),
                                           nprobe * IVF_PW)
        return nprobe, p_cap, pool

    def _scan_ivf(self, padded, k_pad, resid, rscales):
        """scan_ivf on either store (:meth:`ivf_search_shape`)."""
        if self.coarse_centroids is None:
            raise ValueError(
                "search_mode='scan_ivf' needs a trained coarse quantizer; "
                "call train()/build() after loading rows (nlist=0 auto-sizes "
                "the partition count)")
        st = self.store.state
        lay = self._ivf_layout()
        nprobe, p_cap, pool = self.ivf_search_shape(padded.shape[0], k_pad)
        # the work asked of the cluster scan, from host sizes: probes of the
        # padded batch, the rows they score at the mean fill, the pool slots
        # the refine re-ranks (the overlay's slots beside them uncounted)
        probes = padded.shape[0] * nprobe
        GLOBAL.bump("ivf.probes", probes)
        GLOBAL.bump("ivf.probed_rows", round(
            probes * self.store.size() / self.coarse_centroids.shape[0]))
        GLOBAL.bump("ivf.pool_rows",
                    padded.shape[0] * min(pool, nprobe * IVF_PW))
        args = (lay.overlay_dev, k_pad, self.metric, nprobe, p_cap, pool,
                max(1, self.config.ivf_winners))
        if self.store.raw:
            return pallas_ivf_refine_raw(padded, lay, st.vectors, st.valid,
                                         st.ids, *args)
        return pallas_ivf_refine_packed(padded, lay, st.packed, st.scales,
                                        st.norms, st.valid, st.ids, *args,
                                        resid=resid, rscales=rscales)

    def _adc_fast(self, padded, k_pad, resid, rscales):
        """adc_fast on either store: chunked once the [Q, N] f32 block would
        pass 512 MB or the [d, N] bf16 reconstruction 1 GB."""
        st = self.store.state
        ct, cbt, cnorms = self._fast_tables()
        need_chunk = (padded.shape[0] * st.capacity * 4 > 512 << 20
                      or st.capacity * self.dim * 2 > 1 << 30)
        chunk = (self._scan_chunk(st.capacity, padded.shape[0])
                 if need_chunk else 0)
        return adc.adc_fast_search(
            padded, ct, cbt, st.valid, st.vectors if self.store.raw else None,
            st.ids, k=k_pad,
            bucket=max(2, min(self.config.adc_bucket, st.capacity // 2)),
            winners=self.config.adc_winners, metric=self.metric,
            chunk_n=chunk, pool_mode=self.config.adc_pool,
            code_norms=cnorms, perm=self.perm,
            packed_base=self._packed_refine_store(),
            select_r=self.config.adc_select_r,
            **self._int8_refine_args(self._int8_refine_store(), resid,
                                     rscales))

    def _scan_pool8(self, padded, k_pad, resid, rscales):
        """scan_pallas_int8 outside :meth:`_mode_program`: B4 over the
        compressed store, B7 over the raw store's global-scale shadow."""
        st = self.store.state
        if not self.store.raw:
            off, sc, cvec = self._scan8p_shadow()
            pool, w = self._pool_shape(k_pad, st.capacity)
            return pallas_scan8p_refine(
                padded, st.packed, st.scales, st.norms, off, sc, cvec,
                st.ids, k_pad, self.metric, pool=pool, w=w, resid=resid,
                rscales=rscales)
        base8, off, sv, sgn, cvec, *_ = self._scan8g_shadow()
        pool, w = self._pool_shape(k_pad, base8.shape[0])
        return pallas_scan8g_refine(padded, st.vectors, base8, off, sv, sgn,
                                    cvec, st.ids, k_pad, self.metric,
                                    pool=pool, w=w)

    def _scan_pool16(self, padded, k_pad, resid, rscales):
        """scan_pallas: B6 over the bf16 shadow."""
        st = self.store.state
        base16, off, sc, cvec, _ = self._scan16_shadow()
        pool, w = self._pool_shape(k_pad, base16.shape[0])
        return pallas_scan_refine(padded, st.vectors, base16, off, sc, cvec,
                                  st.ids, k_pad, self.metric, pool=pool, w=w)

    def _scan_bf16(self, padded, k_pad, resid, rscales):
        """scan_bf16, streamed once its bf16 scores would pass 512 MB."""
        st = self.store.state
        if padded.shape[0] * st.capacity * 2 > 512 << 20:
            bn = max(131072, min(st.capacity,
                                 (1 << 28) // max(padded.shape[0], 1)))
            bn -= bn % 128
        else:
            bn = 0
        return bf16_scan_refine(
            padded, st.vectors, st.norms, st.valid, st.ids, k_pad,
            self.metric, min(max(4 * k_pad, 32), st.capacity), block_n=bn)

    def _scan_int8(self, padded, k_pad, resid, rscales):
        """scan_int8: the exhaustive scan over int8 rows."""
        st = self.store.state
        i8 = self._int8_refine_store()
        if i8 is None:
            raise ValueError("search_mode='scan_int8' needs "
                             "raw_store=False or refine_store='int8'")
        with span("index.scan"):
            dists, slots = blocked_knn_int8(
                padded, i8[0], i8[1], st.valid, k_pad, metric=self.metric,
                b_norms=st.norms, block_n=min(262144, st.capacity),
                resid=resid, rscales=rscales)
        return dists, slot_ids(slots, st.ids)

    #: the searches of the modes that have one of their own (beside the
    #: padded-8 program's, :meth:`_mode_program`); every other mode runs
    #: the graph where one is built, else the adc scan
    _MODE_SEARCH = {"scan_pallas_int8": _scan_pool8,
                    "scan_pallas": _scan_pool16, "scan_bf16": _scan_bf16,
                    "scan_int8": _scan_int8, "adc_fast": _adc_fast,
                    "scan_ivf": _scan_ivf, "pca": _pca}

    # ---------------------------------------------------------------- state
    def size(self) -> int:
        return self.store.size()

    def get(self, vec_id: int) -> Optional[np.ndarray]:
        return self.store.get(vec_id)

    def stats(self) -> dict:
        s = super().stats()
        sub = self.config.num_subspaces
        cap = self.store.capacity
        code_bytes = cap * sub
        cb_bytes = (self.codebooks.numel() * 4
                    if self.codebooks is not None else 0)
        # store_bytes is what is resident: f32 rows, or packed int8 rows +
        # scales + exact norms (+ the residual level); raw_bytes is the f32
        # size of the rows, as in the reference
        if self.store.raw:
            store_bytes = cap * self.dim * 4
        else:
            store_bytes = cap * (self.dim + 8)
            if self.store.state.resid is not None:
                store_bytes += cap * (self.dim + 4)
        graph_bytes = (self.graph.neighbors.numel() * 4
                       if self.config.use_graph else 0)
        proxy_bytes = self.proxy.numel() * 2 if self.proxy is not None else 0
        s.update(
            trained=self.trained,
            num_subspaces=sub,
            num_centroids=self.config.num_centroids,
            compression_ratio=4.0 * self.dim / sub,
            index_bytes=code_bytes + cb_bytes + graph_bytes + proxy_bytes,
            proxy_bytes=proxy_bytes,
            raw_bytes=cap * self.dim * 4,
            store_bytes=store_bytes,
            raw_store=self.store.raw,
            use_graph=self.config.use_graph,
            pending_inserts=int(self._pending_count),
            device=str(self.device),
        )
        return s

    # ------------------------------------------------------------ persistence
    def state_arrays(self) -> dict:
        """Host arrays under the reference's checkpoint keys; the graph
        (complete: pending rows are connected first) only with
        ``use_graph``, the proxy only when fitted."""
        if self.config.use_graph:
            self.flush_pending()
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
        if self.coarse_centroids is not None:
            out["coarse_centroids"] = self.coarse_centroids.cpu().numpy()
            out["coarse_assign"] = self.coarse_assign
        if self.config.use_graph:
            out["graph"] = graph_to_host(self.graph)
        if self.proxy is not None:
            out["pca_mean"] = self.pca_mean.cpu().numpy()
            out["pca_basis"] = self.pca_basis.cpu().numpy()
            out["proxy"] = self.proxy.cpu().to(torch.float32).numpy()
        return out

    def load_state_arrays(self, arrays: dict) -> None:
        """Load ``state_arrays()`` of either package, raw or compressed
        store, with the coarse quantizer, the proxy and (under
        ``use_graph``; the reference always writes one) the graph when it
        has them (numpy arrays) onto this index's device."""
        dev = self.device
        self.store = VectorStore.from_host(arrays["store"], dev)
        self._init_pending(self.store.capacity)  # checkpoints: complete graphs
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
        if "coarse_centroids" in arrays:
            self._set_coarse(torch.tensor(
                np.asarray(arrays["coarse_centroids"], np.float32),
                device=dev))
            self.coarse_assign = np.asarray(arrays["coarse_assign"],
                                            np.int32).copy()
        else:
            self._set_coarse(None)
            self.coarse_assign = np.full(self.store.capacity, -1, np.int32)
        if self.config.use_graph:
            if "graph" not in arrays:
                raise ValueError(
                    "use_graph=True needs a checkpoint with a graph; load "
                    "with use_graph=False, or build() after loading")
            self.graph = graph_from_host(arrays["graph"], dev)
        if "proxy" in arrays:
            self.pca_mean = torch.tensor(
                np.asarray(arrays["pca_mean"], np.float32), device=dev)
            self.pca_basis = torch.tensor(
                np.asarray(arrays["pca_basis"], np.float32), device=dev)
            self.proxy = torch.tensor(
                np.asarray(arrays["proxy"], np.float32)).to(
                    torch.bfloat16).to(dev)
        else:
            self.pca_mean = self.pca_basis = self.proxy = None
        # the new store restarts its version: drop every derived cache
        self._codes_version += 1
        self._note_store_rewrite()
        self._q8.clear()


def flagship_search(queries, codebooks, codes, valid, base, ids, k, refine,
                    impl, block_n, metric, perm=None, int8_base=None,
                    int8_scales=None, int8_norms=None, int8_resid=None,
                    int8_rscales=None):
    """The ``adc`` search: distance tables -> exhaustive blocked ADC scan
    with a running top-``refine`` (``ops/adc.adc_scan_topk``) -> re-rank
    against the raw rows or the int8 store -> (dists [Q, k], external ids
    [Q, k], -1 where empty)."""
    tables = adc.build_distance_tables(
        _cosine_pq_queries(queries, metric, perm), codebooks)
    _, cand = adc.adc_scan_topk(tables, codes, valid, refine,
                                block_n=block_n, impl=impl)
    return _rerank_any(queries, base, cand, ids, k, metric, int8_base,
                       int8_scales, int8_norms, int8_resid, int8_rscales)


def _cosine_pq_queries(queries, metric, perm):
    """Queries as the quantizer sees them: normalized under cosine (the
    codes hold the unit sphere), then permuted."""
    q = normalize_rows(queries) if metric == "cosine" else queries
    return q if perm is None else q[:, perm]


def _rerank_any(queries, base, cand, ids, k, metric, int8_base, int8_scales,
                int8_norms=None, int8_resid=None, int8_rscales=None):
    """Re-rank candidate slots against the int8 store when given, else the
    raw rows, mapped to external ids."""
    if int8_base is not None:
        d, slots = blocked_rerank_int8(
            queries, int8_base, int8_scales, cand, k, metric,
            b_norms=int8_norms, resid=int8_resid, rscales=int8_rscales)
    else:
        d, slots = blocked_rerank(queries, base, cand, k, metric)
    ext = torch.where(torch.isfinite(d), ids[slots.clamp(min=0).long()],
                      torch.full_like(slots, -1).to(ids.dtype))
    return d, ext


#: candidates scored per step of the pruned adc scan
PRUNED_BLOCK = 2048


def flagship_search_pruned(queries, codebooks, codes, valid, base, ids,
                           centroids, members, overflow, k, refine, nprobe,
                           max_len, metric, perm=None, int8_base=None,
                           int8_scales=None, int8_norms=None,
                           int8_resid=None, int8_rscales=None):
    """The cluster-pruned ``adc`` search: the ``nprobe`` nearest coarse
    centroids of each query -> their members from the [nlist, max_len]
    table plus the shared overflow list -> ADC scores in blocks of
    ``PRUNED_BLOCK`` candidates with a running top-``refine`` (the whole
    [Q, C, S] gather of the codes is never built) -> re-rank -> (dists
    [Q, k], external ids [Q, k]).  Under cosine the centroids live on the
    sphere, so the probing query is normalized too."""
    q_n = queries.shape[0]
    tables = adc.build_distance_tables(
        _cosine_pq_queries(queries, metric, perm), codebooks)
    q_probe = normalize_rows(queries) if metric == "cosine" else queries
    cd = (torch.sum(q_probe * q_probe, dim=1)[:, None]
          + torch.sum(centroids * centroids, dim=1)[None, :]
          - 2.0 * (q_probe @ centroids.T))
    probes = torch.topk(cd, nprobe, dim=1, largest=False, sorted=True)[1]
    cand = torch.cat([members[probes].reshape(q_n, nprobe * max_len),
                      overflow[None, :].expand(q_n, -1)], dim=1)
    cand = torch.where(valid[cand.clamp(min=0).long()], cand, -1)
    c_total = cand.shape[1]
    r = min(refine, c_total)
    dist = hg._adc_dist(codes, tables)
    top_d = torch.full((q_n, r), float("inf"), device=queries.device)
    top_i = torch.full((q_n, r), -1, dtype=torch.int32,
                       device=queries.device)
    for start in range(0, c_total, PRUNED_BLOCK):
        cnd = cand[:, start:start + PRUNED_BLOCK]
        top_d, top_i = merge_topk(top_d, top_i, dist(cnd), cnd, r)
    return _rerank_any(queries, base, top_i, ids, k, metric, int8_base,
                       int8_scales, int8_norms, int8_resid, int8_rscales)


def hnsw_pq_search(graph, codes, tables, valid, ef):
    """Graph traversal with ADC distances: greedy descent on the upper
    levels, an ef-beam on level 0 (``expand`` 4, at most ef steps), all with
    quantized distances; dead slots dropped from the pool.  The caller
    re-ranks exactly.  Returns (pool_d [Q, ef], pool_i [Q, ef])."""
    pool_d, pool_i = hg._descend_and_beam(
        graph, hg._adc_dist(codes, tables), tables.shape[0], ef, ef, 4)
    ok = (pool_i >= 0) & valid[pool_i.clamp(min=0).long()]
    return (torch.where(ok, pool_d, float("inf")),
            torch.where(ok, pool_i, -1))


def _graph_refine_pending(queries, base, valid, cand, pending, k, metric):
    """Blocked exact refine of the graph pool, plus an exact overlay over
    the deferred slots (``pending`` [P], -1 padded) scored with ONE [Q, P]
    product and merged by top-k.  Pending slots are disjoint from graph
    nodes, so the merge cannot duplicate ids.  Returns (dists [Q, k],
    slots [Q, k])."""
    d_g, i_g = blocked_rerank(queries, base, cand, k, metric)
    safe = pending.clamp(min=0).long()
    pv = base[safe]                                              # [P, d]
    dots = queries @ pv.T
    if metric == "l2":
        qn = torch.sum(queries * queries, dim=1)
        pn = torch.sum(pv * pv, dim=1)
        d_p = (qn[:, None] + pn[None, :] - 2.0 * dots).clamp_(min=0.0)
    else:
        qn = torch.linalg.norm(queries, dim=1, keepdim=True)
        pn = torch.linalg.norm(pv, dim=1)[None, :]
        d_p = 1.0 - dots / torch.clamp(qn * pn, min=1e-12)
    ok = (pending >= 0) & valid[safe]
    d_p = torch.where(ok[None, :], d_p, float("inf"))
    d_p, i_p = hg._nearest_m(d_p, pending[None, :].expand(d_p.shape[0], -1),
                             min(k, d_p.shape[1]))
    return hg._nearest_m(torch.cat([d_g, d_p], dim=1),
                         torch.cat([i_g, i_p.to(i_g.dtype)], dim=1), k)


def _auto_scan_mode(use_graph: bool, n_live: int) -> str:
    """search_mode="auto": graph only when configured, the exact scan below
    700,000 live rows, the int8 pool kernel at and above (the reference's
    crossover, measured on its own hardware; the port's is ROADMAP A8)."""
    if use_graph:
        return "graph"
    if n_live >= AUTO_INT8_MIN_ROWS:
        return "scan_pallas_int8"
    return "scan_exact"


def _shadow_centering(vectors, valid, metric):
    """The centering of the raw-store scan shadows, from the live rows of
    the first 4096 slots: (center_vec, aux) = (mu, |mu|^2) under L2, (the
    mean direction cdir, the mean cosine c0 to it) under cosine."""
    m = min(4096, vectors.shape[0])
    pref = vectors[:m]
    w = valid[:m].to(torch.float32)
    wsum = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(pref * w[:, None], dim=0) / wsum
    musq = torch.sum(mu * mu)
    if metric == "cosine":
        cvec = mu * torch.rsqrt(torch.clamp(musq, min=1e-12))
        pn = torch.sqrt(torch.clamp(torch.sum(pref * pref, dim=1), min=1e-12))
        return cvec, torch.sum((pref @ cvec) / pn * w) / wsum
    return mu, musq


def _center_shadow_rows(rows, rnorms, cvec, aux, metric):
    """(ctr, off) of store rows against a fixed centering, shared by the
    int8 shadows' builds and updates so all quantize exactly alike:

      * sq-L2: ctr = v - mu, off = ||v - mu||^2 (exact f32);
      * cosine: ctr = v_hat - c0 cdir, off = -(v_hat . cdir)."""
    if metric == "cosine":
        vhat = rows * torch.rsqrt(torch.clamp(rnorms, min=1e-12))[:, None]
        return vhat - aux * cvec[None, :], -(vhat @ cvec)
    return rows - cvec[None, :], rnorms + aux - 2.0 * (rows @ cvec)


def _quantize_shadow_rows(rows, rnorms, rvalid, cvec, aux, metric):
    """Per-row shadow rows against a fixed centering: (r8 int8, off f32,
    sc f32) with r8 = round(ctr / sv), sv = max|ctr| / 127 and sc = -2 sv
    (sq-L2) or -sv (cosine).  Dead rows get off = +inf."""
    ctr, off = _center_shadow_rows(rows, rnorms, cvec, aux, metric)
    sgn = -1.0 if metric == "cosine" else -2.0
    sv = torch.clamp(torch.amax(torch.abs(ctr), dim=1), min=1e-12) / 127.0
    r8 = torch.clamp(torch.round(ctr / sv[:, None]), -127, 127).to(torch.int8)
    off = torch.where(rvalid, off, float("inf"))
    return r8, off, sgn * sv


def _build_scan8_shadow(vectors, norms, valid, metric, pad_to):
    """int8 scan shadow of the whole store: (base8 [N', d'] int8, off [N'],
    sc [N'], center_vec [d], aux).  N' pads the rows to a multiple of
    ``pad_to`` (off = +inf, sc = 0) and d' the columns to a multiple of 4
    with zeros (whole 4-byte words for the kernel); both paddings happen
    here, once per build, never per search.  The centering is
    :func:`_shadow_centering`; rows are quantized SHADOW_BUILD_ROWS at a
    time.
    """
    n, d = vectors.shape
    cvec, aux = _shadow_centering(vectors, valid, metric)
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


def _build_scan8g_shadow(vectors, norms, valid, metric, pad_to):
    """Global-scale int8 shadow for ``fused_int8g_pool``: the centering and
    offsets of :func:`_build_scan8_shadow`, but ONE scale for the corpus,
    sv = max over live rows of max|ctr| / 127 (a dead row must not stretch
    the range), base8 = round(ctr / sv).  Returns (base8 [N', d'], off
    [N'], sv (0-d), sgn, center_vec, aux), padded like the per-row shadow;
    the selection score is off[n] - sgn * sv * sq * (q8 . v8_n), sgn = 2
    under L2 and 1 under cosine.  Two passes of SHADOW_BUILD_ROWS rows:
    the scale, then the rows."""
    n, d = vectors.shape
    cvec, aux = _shadow_centering(vectors, valid, metric)
    dev = vectors.device
    amax = torch.zeros((), device=dev)
    for s in range(0, n, SHADOW_BUILD_ROWS):
        e = min(n, s + SHADOW_BUILD_ROWS)
        ctr, _ = _center_shadow_rows(vectors[s:e], norms[s:e], cvec, aux,
                                     metric)
        rows = torch.where(valid[s:e], torch.amax(torch.abs(ctr), dim=1), 0.0)
        amax = torch.maximum(amax, torch.amax(rows))
    sv = torch.clamp(amax, min=1e-12) / 127.0
    base8 = torch.zeros((n + (-n) % pad_to, d + (-d) % 4), dtype=torch.int8,
                        device=dev)
    off = torch.full((base8.shape[0],), float("inf"), device=dev)
    for s in range(0, n, SHADOW_BUILD_ROWS):
        e = min(n, s + SHADOW_BUILD_ROWS)
        base8[s:e, :d], off[s:e] = _quantize_global_rows(
            vectors[s:e], norms[s:e], valid[s:e], cvec, aux, sv, metric)[:2]
    return base8, off, sv, 1.0 if metric == "cosine" else 2.0, cvec, aux


def _quantize_global_rows(rows, rnorms, rvalid, cvec, aux, sv, metric):
    """(r8, off, clipped) of store rows against a fixed centering and
    global scale: r8 = clip(round(ctr / sv), +-127), dead rows off = +inf,
    ``clipped`` the live rows with some |ctr| > 127 sv."""
    ctr, off = _center_shadow_rows(rows, rnorms, cvec, aux, metric)
    r8 = torch.clamp(torch.round(ctr / sv), -127, 127).to(torch.int8)
    clipped = torch.any(torch.abs(ctr) > 127.0 * sv, dim=1) & rvalid
    return r8, torch.where(rvalid, off, float("inf")), clipped


def _update_scan8g_shadow(base8, off, vectors, norms, valid, slots, cvec,
                          aux, sv, metric) -> int:
    """Requantize only ``slots`` (unique) against the cached centering and
    the cached global scale, in place; returns how many of them are live
    rows that clipped (the caller rebuilds once they accumulate)."""
    r8, off_s, clipped = _quantize_global_rows(
        vectors[slots], norms[slots], valid[slots], cvec, aux, sv, metric)
    base8[slots, :r8.shape[1]] = r8
    off[slots] = off_s
    return int(clipped.sum())


def _condition16_rows(rows, rnorms, rvalid, cvec, aux, metric):
    """(off, sc) of the bf16 shadow for store rows against a fixed
    centering (:func:`_build_scan16_shadow`).  Dead rows get off = +inf."""
    if metric == "cosine":
        (c0,) = aux
        iv = torch.rsqrt(torch.clamp(rnorms, min=1e-12))
        off = c0 - (rows @ cvec) * iv
        sc = -iv
    else:
        musq, mean_norm = aux
        off = rnorms + musq - 2.0 * (rows @ cvec) - (mean_norm - musq)
        sc = torch.full_like(rnorms, -2.0)
    return torch.where(rvalid, off, float("inf")), sc


def _build_scan16_shadow(vectors, norms, valid, metric, pad_to):
    """bf16 scan shadow for ``fused_raw_pool``: (base16 [N', d'] bf16, off
    [N'], sc [N'], center_vec [d], aux).  The conditioning is
    ``ops/distance.bf16_pool_scan``'s: queries center by the prefix mean mu
    (the mean direction under cosine) and every large common-mode term is
    folded into the f32 offsets, so the bf16 product carries only
    O(noise)-scale signal:

      * sq-L2: off = ||v||^2 + |mu|^2 - 2 mu.v - (E||v||^2 - |mu|^2),
        sc = -2, aux = (|mu|^2, E||v||^2 over live rows);
      * cosine: off = c0 - (cdir . v) / |v|, sc = -1/|v|, aux = (c0,).

    N' pads the rows to a multiple of ``pad_to`` (off = +inf, sc = 0) and
    d' the columns to a multiple of 8 with zeros (whole 16-byte rows for
    the kernel), once per build, never per search."""
    n, d = vectors.shape
    cvec, c = _shadow_centering(vectors, valid, metric)
    if metric == "cosine":
        aux = (c,)
    else:
        live = torch.clamp(torch.sum(valid.to(torch.float32)), min=1.0)
        aux = (c, torch.sum(torch.where(valid, norms, 0.0)) / live)
    dev = vectors.device
    n_pad = n + (-n) % pad_to
    base16 = torch.zeros((n_pad, d + (-d) % 8), dtype=torch.bfloat16,
                         device=dev)
    off = torch.full((n_pad,), float("inf"), device=dev)
    sc = torch.zeros((n_pad,), device=dev)
    for s in range(0, n, SHADOW_BUILD_ROWS):
        e = min(n, s + SHADOW_BUILD_ROWS)
        base16[s:e, :d] = vectors[s:e].to(torch.bfloat16)
        off[s:e], sc[s:e] = _condition16_rows(
            vectors[s:e], norms[s:e], valid[s:e], cvec, aux, metric)
    return base16, off, sc, cvec, aux


def _update_scan16_shadow(base16, off, sc, vectors, norms, valid, slots,
                          cvec, aux, metric) -> None:
    """Recondition only ``slots`` against the cached centering, in place."""
    rows = vectors[slots]
    base16[slots, :rows.shape[1]] = rows.to(torch.bfloat16)
    off[slots], sc[slots] = _condition16_rows(
        rows, norms[slots], valid[slots], cvec, aux, metric)


def _build_scan8p_shadow(packed, scales, norms, valid, metric):
    """Conditioning vectors for the packed-store scan: (off [N], sc [N],
    center_vec [d]); no corpus copy.  The rows were quantized uncentered
    at write time; centering is query-side, with the per-slot cross term
    ``cvec . v8_n`` folded into the offset by one blocked decode pass
    (SHADOW_BUILD_ROWS rows a step; the last block may be short):

      * sq-L2: off = norms - 2 scale (mu . v8), sc = -2 scale; queries
        center as q - mu (mu: mean of the first 4096 slots' live rows).
      * cosine: off = -scale/|v| (cdir . v8), sc = -scale/|v|; queries
        center as q_hat - cdir.

    Dead slots get off = +inf."""
    n = packed.shape[0]
    m = min(4096, n)
    pref = words_to_f32(packed[:m]) * scales[:m, None]
    w = valid[:m].to(torch.float32)
    wsum = torch.clamp(torch.sum(w), min=1.0)
    if metric == "cosine":
        pn = torch.sqrt(torch.clamp(torch.sum(pref * pref, dim=1), min=1e-12))
        mu = torch.sum(pref / pn[:, None] * w[:, None], dim=0) / wsum
        cvec = mu * torch.rsqrt(torch.clamp(torch.sum(mu * mu), min=1e-12))
    else:
        cvec = torch.sum(pref * w[:, None], dim=0) / wsum
    corr = torch.cat([words_to_f32(packed[s:s + SHADOW_BUILD_ROWS]) @ cvec
                      for s in range(0, n, SHADOW_BUILD_ROWS)])
    if metric == "cosine":
        sc = -scales * torch.rsqrt(torch.clamp(norms, min=1e-12))
        off = sc * corr
    else:
        sc = -2.0 * scales
        off = norms - 2.0 * scales * corr
    return torch.where(valid, off, float("inf")), sc, cvec


def _recon_norms(ct_blk, cbt):
    """Squared reconstruction norms of one code chunk, from the decode
    kernel's bf16 reconstruction."""
    r = pq_decode_recon_t(ct_blk, cbt).to(torch.float32)
    return torch.sum(r.square_(), dim=0)


def _build_fast_tables(codes, codebooks) -> tuple:
    """(codes_t [S, cap] uint8 contiguous, cbt [S*sd, K], reconstruction
    norms [cap]) of the decode kernel, the norms in RECON_NORM_CHUNK-column
    decode passes (never a [d, cap] reconstruction)."""
    ct = codes.T.contiguous()
    cbt = adc.codebooks_to_cbt(codebooks)
    cnorms = torch.cat([_recon_norms(ct[:, s:s + RECON_NORM_CHUNK], cbt)
                        for s in range(0, ct.shape[1], RECON_NORM_CHUNK)])
    return ct, cbt, cnorms


def _update_fast_tables(ct, cnorms, codes, codebooks, slots) -> None:
    """Refresh the ADC tables of re-encoded slots in place: their codes_t
    columns, and their reconstruction norms from per-subspace square norms
    of the bf16-rounded codebook entries (the values the decode pass
    produces, summed in another order: within ~1e-6 of a rebuild)."""
    sub = codes[slots].long()                                  # [m, S]
    cb16 = codebooks.to(torch.bfloat16).to(torch.float32)
    cb_sq = torch.sum(cb16 * cb16, dim=2)                      # [S, K]
    s_idx = torch.arange(sub.shape[1], device=sub.device)[None, :]
    ct[:, slots] = sub.T.to(ct.dtype)
    cnorms[slots] = torch.sum(cb_sq[s_idx, sub], dim=1)


def _pool_select_cand(queries, center_vec, metric, pool_kernel, pool_args,
                      pool, w):
    """Center (and under cosine normalize) the queries, run the pool
    kernel, and keep the ``pool`` best of the [Q, w] bucket winners with an
    exact top-k: candidate slots [Q, pool], -1 where empty.  (The
    reference selects with ``approx_max_k(recall_target=0.95)``.)"""
    with span("index.scan"):
        q = normalize_rows(queries) if metric == "cosine" else queries
        qc = q - center_vec[None, :]
        vals, idx = pool_kernel(qc, *pool_args, w)
        nv, sel = torch.topk(vals, pool, dim=1, largest=False, sorted=True)
        cand = torch.gather(idx, 1, sel)
        return torch.where(torch.isfinite(nv), cand,
                           torch.full_like(cand, -1))


def pallas_scan8p_refine(queries, packed, scales, norms, off, sc, center_vec,
                         ids, k, metric, pool, w, resid=None, rscales=None):
    """The compressed tier's exhaustive scan: the packed pool kernel
    (``ops/kernels.fused_packed_pool``) over the store's own int8 rows,
    an exact top-``pool`` of its bucket winners, then the int8 refine with
    exact write-time norms (+ the residual level): returns (dists [Q, k],
    external ids [Q, k], -1 where empty)."""
    cand = _pool_select_cand(queries, center_vec, metric, fused_packed_pool,
                             (packed, off, sc), pool, w)
    with span("index.refine"):
        d, slots = blocked_rerank_int8(queries, packed, scales, cand, k,
                                       metric, rb=pool, b_norms=norms,
                                       resid=resid, rscales=rscales)
        ext = torch.where(torch.isfinite(d), ids[slots.clamp(min=0).long()],
                          torch.full_like(slots, -1).to(ids.dtype))
    return d, ext


def _rerank_to_ids(queries, base, cand, ids, k, metric, rb):
    """Exact f32 re-rank of candidate slots [Q, R] (-1 ignored) in blocks
    of ``rb``, mapped to external ids: (dists [Q, k], ids [Q, k], -1
    where empty)."""
    with span("index.refine"):
        d, slots = blocked_rerank(queries, base, cand, k, metric, rb=rb)
        ext = torch.where(torch.isfinite(d), ids[slots.clamp(min=0).long()],
                          torch.full_like(slots, -1))
    return d, ext


def pallas_scan8_refine(queries, base, base8, off, sc, center_vec, ids, k,
                        metric, pool, w):
    """int8 pool kernel scan + exact f32 re-rank of the pool: returns
    (dists [Q, k], external ids [Q, k], -1 where empty).  The name is the
    reference's; the pool runs ``ops/kernels.fused_int8_pool``."""
    cand = _pool_select_cand(queries, center_vec, metric, fused_int8_pool,
                             (base8, off, sc), pool, w)
    return _rerank_to_ids(queries, base, cand, ids, k, metric, pool)


def pallas_scan8g_refine(queries, base, base8, off, sv, sgn, center_vec, ids,
                         k, metric, pool, w):
    """:func:`pallas_scan8_refine` over the global-scale shadow: the pool
    runs ``ops/kernels.fused_int8g_pool`` (ranked in int32), then the same
    select and exact f32 re-rank."""
    cand = _pool_select_cand(queries, center_vec, metric, fused_int8g_pool,
                             (base8, off, sv, sgn), pool, w)
    return _rerank_to_ids(queries, base, cand, ids, k, metric, pool)


def pallas_scan_refine(queries, base, base16, off, sc, center_vec, ids, k,
                       metric, pool, w):
    """:func:`pallas_scan8_refine` over the bf16 shadow: the pool runs
    ``ops/kernels.fused_raw_pool``."""
    cand = _pool_select_cand(queries, center_vec, metric, fused_raw_pool,
                             (base16, off, sc), pool, w)
    return _rerank_to_ids(queries, base, cand, ids, k, metric, pool)


def bf16_scan_refine(queries, base, norms, valid, ids, k, metric, pool,
                     block_n=0):
    """bf16-selection scan (``ops/distance.bf16_pool_scan``, streamed in
    ``block_n``-row blocks when given) + exact f32 re-rank of its ``pool``
    candidates: returns (dists [Q, k], external ids [Q, k], -1 where
    empty)."""
    with span("index.scan"):
        cand = bf16_pool_scan(queries, base, valid, pool, metric=metric,
                              b_norms=norms, block_n=block_n)
    return _rerank_to_ids(queries, base, cand, ids, k, metric, pool)


def exact_scan_search(queries, base, norms, valid, ids, k, metric, block_n):
    """Exact f32 scan + external-id map: the flagship's search below the
    crossover."""
    with span("index.scan"):
        d, slots = blocked_knn_fast(queries, base, valid, k, metric=metric,
                                    b_norms=norms, block_n=block_n)
        ext = torch.where(slots >= 0, ids[slots.clamp(min=0).long()],
                          torch.full_like(slots, -1))
    return d, ext


class _IvfLayout(NamedTuple):
    """The balanced cluster-major layout of scan_ivf (built by
    ``HnswPqIndex._build_ivf_layout``; ``ops/ivf_scan`` has the design)."""

    centroids: torch.Tensor  # [nlist, d] coarse centroids (probe space)
    cm_packed: torch.Tensor  # [nlist*cap, d/4] int32 cluster-major int8 rows
    off_cm: torch.Tensor     # [nlist*cap] f32 selection offset (+inf pads)
    sc_cm: torch.Tensor      # [nlist*cap] f32 selection scale
    cvec: torch.Tensor       # [d] query centering vector
    pos2slot: torch.Tensor   # [nlist*cap] int32 grid position -> store slot
    slot2pos: torch.Tensor   # [capacity] int32 store slot -> grid position
    cap: int                 # rows per cluster
    spilled: int             # rows placed outside their top-8 clusters
    overlay: np.ndarray      # slots written since, scored exactly (host)
    overlay_dev: Optional[torch.Tensor]  # it -1 padded to pow2, or None


def _gather_ivf_cm(packed_src, off, sc, pos2slot):
    """The packed rows and their conditioning in cluster-major order (one
    row gather; the -1 pads of the grid get off = +inf, sc = 0)."""
    live = pos2slot >= 0
    safe = pos2slot.clamp(min=0).long()
    return (packed_src[safe], torch.where(live, off[safe], float("inf")),
            torch.where(live, sc[safe], 0.0))


def _ivf_candidates_overlay(queries, lay, valid, overlay, metric, nprobe,
                            p_cap, pool, winners):
    """The head of both scan_ivf refines: the pruned candidates
    (``ivf_scan.ivf_pool_candidates``) with dead slots dropped, and the
    live overlay slots appended to every query's candidates (disjoint from
    the pool: their grid positions are disabled).  The span
    ``index.scan``: the probe, the prober inversion, the cluster scan, the
    pool select and the overlay's merge."""
    with span("index.scan"):
        _, slots = ivf_scan.ivf_pool_candidates(
            queries, lay.centroids, lay.cm_packed, lay.off_cm, lay.sc_cm,
            lay.cvec, lay.pos2slot, metric, nprobe, p_cap, pool, winners)
        slots = torch.where((slots >= 0) & valid[slots.clamp(min=0).long()],
                            slots, -1)
        if overlay is not None:
            ov = torch.where((overlay >= 0) & valid[overlay.clamp(min=0)],
                             overlay, -1).to(slots.dtype)
            slots = torch.cat([slots, ov[None, :].expand(slots.shape[0], -1)],
                              dim=1)
        return slots


def pallas_ivf_refine_packed(queries, lay, packed, scales, norms, valid, ids,
                             overlay, k, metric, nprobe, p_cap, pool,
                             winners, resid=None, rscales=None):
    """scan_ivf on the compressed store: the pruned candidates, then the
    int8 (+ residual) refine with exact write-time norms: (dists [Q, k],
    external ids [Q, k], -1 where empty).  The name is the reference's;
    the pool runs ``ops/kernels.fused_ivf_pool``."""
    cand = _ivf_candidates_overlay(queries, lay, valid, overlay, metric,
                                   nprobe, p_cap, pool, winners)
    with span("index.refine"):
        d, slots = blocked_rerank_int8(queries, packed, scales, cand, k,
                                       metric, b_norms=norms, resid=resid,
                                       rscales=rscales)
        ext = torch.where(torch.isfinite(d), ids[slots.clamp(min=0).long()],
                          torch.full_like(slots, -1).to(ids.dtype))
    return d, ext


def pallas_ivf_refine_raw(queries, lay, base, valid, ids, overlay, k, metric,
                          nprobe, p_cap, pool, winners):
    """scan_ivf on the raw store: the pruned candidates, then the exact f32
    refine."""
    cand = _ivf_candidates_overlay(queries, lay, valid, overlay, metric,
                                   nprobe, p_cap, pool, winners)
    return _rerank_to_ids(queries, base, cand, ids, k, metric, 512)
