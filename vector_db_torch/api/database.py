"""VectorDatabase — the user-facing facade with its Builder (the
counterpart of ``vector_db_tpu/api/database.py``).

The same API, WAL and checkpoint format as the reference, with one
addition: the device is explicit (``device=``, ``Builder.with_device``;
default ``"cuda"``, which raises where CUDA is absent).  The index factory
serves all seven index types (BRUTE, HNSW, HNSWPQ, PQ, IVF, LSH, ANNOY)
with the reference's default configurations.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import on_default_stream, resolve_device
from ..core.types import SearchResult, Vector, make_results_batch
from ..index.base import VectorIndex
from ..storage import checkpoint as ckpt
from ..utils.locks import RWLock
from ..utils.stats import GLOBAL, span, timed
from .config import (AnnoyConfig, CompressionConfig, CompressionType,
                     HnswPqConfig, IvfConfig, LshConfig, PqConfig)

FORMAT_VERSION = 1


def _reads(fn):
    """Concurrent-reader facade method (utils/locks.RWLock), its device work
    on the device's default stream (core/device.on_default_stream)."""
    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        with self._rw.read(), on_default_stream(self.device):
            return fn(self, *a, **k)
    return wrapper


def _search_call(root: str):
    """A search method: as :func:`_reads`, inside the span ``root``, the
    call's root (utils/stats), so that the lock and the stream guard count
    as the facade's time."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *a, **k):
            with span(root), self._rw.read(), \
                    on_default_stream(self.device):
                return fn(self, *a, **k)
        return wrapper
    return deco


def _writes(fn):
    """Exclusive-writer facade method: the store is written in place, so
    a write must never overlap a search or another write, on the host or
    on the card (the default stream, as for the readers)."""
    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        with self._rw.write(), on_default_stream(self.device):
            return fn(self, *a, **k)
    return wrapper


class IndexType(enum.Enum):
    BRUTE = "brute"
    HNSW = "hnsw"
    ANNOY = "annoy"
    LSH = "lsh"
    IVF = "ivf"
    PQ = "pq"
    HNSWPQ = "hnswpq"


def _create_index(index_type: IndexType, dim: int, capacity: int,
                  metric: str, compression: CompressionConfig,
                  index_config=None, device="cuda") -> VectorIndex:
    """Index factory; a PQ/HNSWPQ CompressionConfig overrides the plain
    index choice, as in the reference."""
    if compression.enabled and index_type in (
            IndexType.HNSW, IndexType.HNSWPQ, IndexType.PQ):
        if compression.compression_type == CompressionType.HNSWPQ:
            index_type = IndexType.HNSWPQ
        elif compression.compression_type == CompressionType.PQ:
            index_type = IndexType.PQ
    if index_type == IndexType.BRUTE:
        from ..index.brute import BruteForceIndex

        return BruteForceIndex(dim, capacity, metric, device=device)
    if index_type == IndexType.HNSW:
        from ..index.hnsw import HnswIndex

        return HnswIndex(dim, capacity, metric, index_config, device=device)
    if index_type == IndexType.HNSWPQ:
        from ..index.hnsw_pq import HnswPqIndex

        cfg = index_config
        if cfg is None:
            sub = (compression.effective_subspaces(dim) if compression.enabled
                   else max(1, dim // 8))
            cfg = HnswPqConfig(num_subspaces=sub,
                               training_iterations=compression.training_iterations)
        return HnswPqIndex(dim, capacity, metric, cfg, device=device)
    if index_type == IndexType.PQ:
        from ..index.pq import PqIndex

        cfg = index_config
        if cfg is None:
            cfg = PqConfig(num_subspaces=compression.effective_subspaces(dim)
                           if compression.enabled else 8)
        return PqIndex(dim, capacity, metric, cfg, device=device)
    if index_type == IndexType.IVF:
        from ..index.ivf import IvfIndex

        return IvfIndex(dim, capacity, metric, index_config or IvfConfig(),
                        device=device)
    if index_type == IndexType.LSH:
        from ..index.lsh import LshIndex

        return LshIndex(dim, capacity, metric, index_config or LshConfig(),
                        device=device)
    if index_type == IndexType.ANNOY:
        from ..index.annoy import AnnoyIndex

        return AnnoyIndex(dim, capacity, metric,
                          index_config or AnnoyConfig(), device=device)
    raise ValueError(f"unsupported index type: {index_type}")


class VectorDatabase:
    """Embedded vector database on one device::

        db = (VectorDatabase.builder()
              .with_dimension(512)
              .with_max_elements(100_000)
              .with_index_type(IndexType.HNSWPQ)
              .with_storage_path("./data")
              .with_device("cuda")
              .build())
    """

    def __init__(
        self,
        dimension: int,
        max_elements: int,
        index_type: IndexType = IndexType.HNSW,
        metric: str = "l2",
        storage_path: Optional[str] = None,
        compression: Optional[CompressionConfig] = None,
        index_config=None,
        flush_interval: int = 1000,
        auto_load: bool = True,
        durability: str = "flush",
        device="cuda",
    ):
        if dimension <= 0:
            raise ValueError("dimension must be positive")
        if max_elements <= 0:
            raise ValueError("max_elements must be positive")
        self.device = resolve_device(device)
        self.dimension = dimension
        self.max_elements = max_elements
        self.index_type = index_type
        self.metric = metric
        self.storage_path = storage_path
        self.compression = compression or CompressionConfig.default_config()
        self.flush_interval = flush_interval  # checkpoint every N mutations
        self._mutations_since_flush = 0
        self._closed = False
        self._rw = RWLock()
        self.index = _create_index(index_type, dimension, max_elements, metric,
                                   self.compression, index_config, self.device)
        # write-ahead log (native/ engine or its format-identical Python
        # twin): "buffered" | "flush" (default, survives a process crash) |
        # "fsync" (survives an OS crash).  A compressed index
        # (HnswPqConfig.raw_store=False) opens none, as in the reference:
        # its WAL would hold the f32 rows the store exists not to hold, so
        # its durability is the checkpoint (save / close / bulk loads).
        self.durability = durability
        self._engine = None
        compressed = getattr(getattr(self.index, "store", None), "raw",
                             True) is False
        if storage_path and not compressed:
            from ..storage.native import open_engine

            wal_dir = os.path.join(storage_path, "wal")
            os.makedirs(wal_dir, exist_ok=True)
            self._engine = open_engine(wal_dir, dimension, durability=durability)
        if auto_load and storage_path:
            self.load_from_storage()

    # ---------------------------------------------------------------- builder
    @classmethod
    def builder(cls) -> "VectorDatabase.Builder":
        return cls.Builder()

    class Builder:
        def __init__(self):
            self._dim: Optional[int] = None
            self._max: Optional[int] = None
            self._type = IndexType.HNSW
            self._metric = "l2"
            self._path: Optional[str] = None
            self._compression: Optional[CompressionConfig] = None
            self._index_config = None
            self._index: Optional[VectorIndex] = None
            self._durability = "flush"
            self._search_mode: Optional[str] = None
            self._device = "cuda"

        def with_durability(self, durability: str) -> "VectorDatabase.Builder":
            """WAL durability: "buffered" | "flush" (default) | "fsync"."""
            self._durability = durability
            return self

        def with_dimension(self, d: int) -> "VectorDatabase.Builder":
            self._dim = d
            return self

        def with_max_elements(self, m: int) -> "VectorDatabase.Builder":
            self._max = m
            return self

        def with_index_type(self, t) -> "VectorDatabase.Builder":
            self._type = t if isinstance(t, IndexType) else IndexType(str(t))
            return self

        def with_metric(self, metric: str) -> "VectorDatabase.Builder":
            self._metric = metric
            return self

        def with_storage_path(self, p: str) -> "VectorDatabase.Builder":
            self._path = p
            return self

        def with_compression(self, c: CompressionConfig) -> "VectorDatabase.Builder":
            self._compression = c
            return self

        def with_index_config(self, cfg) -> "VectorDatabase.Builder":
            self._index_config = cfg
            return self

        def with_search_mode(self, mode: str) -> "VectorDatabase.Builder":
            """HNSWPQ search-mode shortcut (see HnswPqConfig.search_mode)."""
            self._search_mode = mode
            return self

        def with_index(self, index: VectorIndex) -> "VectorDatabase.Builder":
            """Use a ready-made index."""
            self._index = index
            return self

        def with_device(self, device) -> "VectorDatabase.Builder":
            """The device the store and index live on ("cuda" default)."""
            self._device = device
            return self

        def build(self) -> "VectorDatabase":
            if self._dim is None or self._max is None:
                raise ValueError("dimension and max_elements are required")
            if self._search_mode is not None:
                if self._type is not IndexType.HNSWPQ:
                    raise ValueError("with_search_mode applies to IndexType.HNSWPQ")
                cfg = self._index_config or HnswPqConfig()
                # replace, don't mutate: a shared config keeps its mode
                self._index_config = dataclasses.replace(
                    cfg, search_mode=self._search_mode)
            db = VectorDatabase(
                self._dim, self._max, self._type, self._metric, self._path,
                self._compression, self._index_config,
                auto_load=self._index is None, durability=self._durability,
                device=self._device,
            )
            if self._index is not None:
                db.index = self._index
            return db

    # ------------------------------------------------------------------ CRUD
    @_writes
    def add_vector(self, vec_id: int, values) -> bool:
        """Insert one vector; False on duplicate/overflow/dim-mismatch."""
        self._check_open()
        values = torch.as_tensor(values, dtype=torch.float32)
        if tuple(values.shape) != (self.dimension,):
            return False
        ok = self.index.add(int(vec_id), values)
        if ok:
            if self._engine is not None:
                self._engine.append_add(int(vec_id), values.cpu().numpy())
            self._note_mutation()
        return ok

    @_writes
    def add_batch(self, ids: Sequence[int], values) -> list[int]:
        """Batch insert (numpy array or tensor); returns accepted ids."""
        self._check_open()
        id_list = [int(i) for i in ids]
        accepted = self.index.add_batch(id_list, values)
        if accepted:
            if self._engine is not None:
                # the row of each accepted id's FIRST occurrence (the store
                # keeps the first of a duplicated id)
                first_row: dict[int, int] = {}
                for i, vid in enumerate(id_list):
                    first_row.setdefault(vid, i)
                rows = [first_row[vid] for vid in accepted]
                host = torch.as_tensor(values, dtype=torch.float32).cpu().numpy()
                self._engine.append_add_batch(np.asarray(accepted, np.int32),
                                              host[rows])
            self._note_mutation(len(accepted))
        return accepted

    @_writes
    def bulk_load(self, ids: Sequence[int], vectors) -> list[int]:
        """Bulk ingest of an (ideally device-resident) corpus into an empty
        database, skipping per-row WAL appends; a checkpoint is written
        right after when a storage path is set."""
        self._check_open()
        if not hasattr(self.index, "bulk_load"):
            raise ValueError(f"index kind {self.index.kind!r} has no bulk_load")
        with span("ingest.bulk_load", wait=self.device):
            accepted = self.index.bulk_load(ids, vectors)
            if accepted and self.storage_path:
                self._save_unlocked()
        return accepted

    @_writes
    def bulk_load_stream(self, chunks) -> int:
        """Streamed bulk ingest into an empty database (``chunks`` yields
        (ids, vectors) pairs; see HnswPqIndex.bulk_load_stream): the path
        for corpora whose f32 form the card should not hold, with
        HnswPqConfig(raw_store=False).  A checkpoint is written right after
        when a storage path is set."""
        self._check_open()
        if not hasattr(self.index, "bulk_load_stream"):
            raise ValueError(
                f"index kind {self.index.kind!r} has no bulk_load_stream")
        with span("ingest.bulk_load", wait=self.device):
            n = self.index.bulk_load_stream(chunks)
            if n and self.storage_path:
                self._save_unlocked()
        return n

    @_reads
    def get_vector(self, vec_id: int) -> Optional[Vector]:
        self._check_open()
        vals = self.index.get(int(vec_id))
        return Vector(int(vec_id), vals) if vals is not None else None

    @_writes
    def delete_vector(self, vec_id: int) -> bool:
        self._check_open()
        ok = self.index.remove(int(vec_id))
        if ok:
            if self._engine is not None:
                self._engine.append_delete(int(vec_id))
            self._note_mutation()
        return ok

    # ---------------------------------------------------------------- search
    @_search_call("facade.search")
    def search(self, query, k: int) -> list[SearchResult]:
        """k-NN search for one query."""
        self._check_open()
        q = torch.as_tensor(query, dtype=torch.float32)
        if tuple(q.shape) != (self.dimension,):
            raise ValueError(f"query must have dimension {self.dimension}")
        with span("index.search"):
            ids, dists = self.index.search(q, k)
        with span("facade.results"):
            return make_results_batch(ids[None], dists[None], self.metric)[0]

    @_search_call("facade.search_batch")
    def search_batch(self, queries, k: int) -> list[list[SearchResult]]:
        """Batched k-NN (numpy array or tensor of [Q, dim] queries)."""
        self._check_open()
        with timed("search_batch", span_name="index.search"):
            ids, dists = self.index.search_batch(queries, k)
        GLOBAL.bump("queries", ids.shape[0])
        with span("facade.results"):
            return make_results_batch(ids, dists, self.metric)

    # ------------------------------------------------------------------ state
    @_reads
    def size(self) -> int:
        self._check_open()
        return self.index.size()

    def metrics(self) -> dict:
        """Process-wide operation counters/latencies."""
        return GLOBAL.snapshot()

    @_writes
    def rebuild_index(self) -> None:
        self._check_open()
        self.index.build()

    def stats(self) -> dict:
        return self.index.stats()

    # ---------------------------------------------------------- compression
    def is_compression_enabled(self) -> bool:
        return self.compression.enabled or self.index.kind in ("pq", "hnswpq")

    def get_compression_ratio(self) -> float:
        s = self.index.stats()
        if "compression_ratio" in s:
            return float(s["compression_ratio"])
        return self.compression.compression_ratio(self.dimension)

    def get_memory_savings_pct(self) -> float:
        r = self.get_compression_ratio()
        return (1.0 - 1.0 / r) * 100.0 if r > 0 else 0.0

    # ---------------------------------------------------------- persistence
    def save(self) -> bool:
        """Checkpoint the full database state (store + index structures)."""
        with self._rw.write():
            return self._save_unlocked()

    def _save_unlocked(self) -> bool:
        # callers inside a mutating facade method already hold the write
        # lock (RWLock is not reentrant)
        self._check_open()
        if not self.storage_path:
            return False
        meta = {
            "format_version": FORMAT_VERSION,
            "dimension": self.dimension,
            "max_elements": self.max_elements,
            "index_type": self.index_type.value,
            "index_kind": self.index.kind,
            "metric": self.metric,
            "size": self.index.size(),
        }
        arrays = self.index.state_arrays()
        ckpt.save_checkpoint(self.storage_path, meta, arrays)
        if self._engine is not None:
            # the checkpoint's live set becomes the WAL snapshot (the WAL
            # truncates), from the store arrays already on the host
            snap = arrays["store"]
            live = np.flatnonzero(snap["valid"])
            live = live[np.argsort(snap["ids"][live], kind="stable")]
            self._engine.snapshot(snap["ids"][live].astype(np.int32),
                                  snap["vectors"][live])
        self._mutations_since_flush = 0
        return True

    @_writes
    def load_from_storage(self) -> bool:
        """Restore from the checkpoint (either package's), then replay the
        WAL mutations that came after it."""
        self._check_open()
        if not self.storage_path:
            return False
        loaded = ckpt.load_checkpoint(self.storage_path)
        if loaded is None:
            # no checkpoint: recover everything from the WAL alone
            return self._reconcile_wal() > 0
        meta, arrays = loaded
        if meta.get("dimension") != self.dimension:
            raise ValueError(
                f"checkpoint dimension {meta.get('dimension')} != {self.dimension}")
        if meta.get("index_kind") != self.index.kind:
            # written by another index type: re-add its stored raw rows
            if "store" not in arrays:
                return False
            from ..core.store import VectorStore

            store = VectorStore.from_host(arrays["store"], "cpu")
            ids = store.ids()
            if ids:
                self.index.add_batch(ids, store.rows([store.slot_of(i) for i in ids]))
                self.index.build()
            return True
        self.index.load_state_arrays(arrays)
        self._reconcile_wal()
        return True

    def _reconcile_wal(self) -> int:
        """Bring the index in line with the WAL's live set and rows.
        Returns the number of applied mutations (adds + deletes).

        An id in both whose row differs was deleted and added again after
        the checkpoint: the WAL holds its last write, so it is replaced
        (the reference keeps the checkpoint's row)."""
        if self._engine is None:
            return 0
        wal_ids, wal_vecs = self._engine.load(self.max_elements)
        wal_set = {int(i) for i in wal_ids}
        store = self.index.store
        index_set = set(store.ids())
        applied = 0
        both = [i for i, vid in enumerate(wal_ids) if int(vid) in index_set]
        if both:
            have = store.rows([store.slot_of(int(wal_ids[i]))
                               for i in both]).cpu().numpy()
            stale = np.flatnonzero((have != wal_vecs[both]).any(axis=1))
            for j in stale:
                self.index.remove(int(wal_ids[both[j]]))
                index_set.discard(int(wal_ids[both[j]]))
        missing = [i for i, vid in enumerate(wal_ids) if int(vid) not in index_set]
        if missing:
            self.index.add_batch([int(wal_ids[i]) for i in missing],
                                 wal_vecs[missing])
            applied += len(missing)
        for vid in index_set - wal_set:
            if self.index.remove(vid):
                applied += 1
        return applied

    def close(self) -> None:
        """Checkpoint (with a storage path) and close."""
        with self._rw.write(), on_default_stream(self.device):
            if self._closed:
                return
            if self.storage_path:
                self._save_unlocked()
            if self._engine is not None:
                self._engine.close()
            self._closed = True

    def __enter__(self) -> "VectorDatabase":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------------- private
    def _note_mutation(self, n: int = 1) -> None:
        self._mutations_since_flush += n
        if self.storage_path and self._mutations_since_flush >= self.flush_interval:
            self._save_unlocked()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("database is closed")
