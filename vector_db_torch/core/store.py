"""Device-resident vector store — struct-of-arrays tensors on one device.

The counterpart of ``vector_db_tpu/core/store.py``: the raw f32 tier
(``StoreState``) and the compressed tier (``Int8StoreState``: int8 rows
packed four per int32 word, per-row scales, exact write-time norms, and
optionally a second int8 level holding each row's quantization residual).
The arrays are preallocated at a capacity rounded up to 128 (compressed: then
to 2048) and updated IN PLACE (the reference builds a new immutable pytree
per write; here the facade's reader-writer lock keeps searches off a store
being written).

Slot management (id -> slot map, LIFO freelist) is host-side metadata and
assigns the same slots as the reference for the same sequence of adds and
removes, which is what lets a checkpoint cross-load.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.distance import (pack_int8_residual, pack_int8_rows,
                            unpack_int8_rows)
from .device import resolve_device


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class StoreState:
    """The corpus as device tensors."""

    vectors: torch.Tensor  # [cap, dim] float32
    ids: torch.Tensor      # [cap] int32 external ids, -1 for empty slots
    norms: torch.Tensor    # [cap] float32 squared L2 norms
    valid: torch.Tensor    # [cap] bool live-slot mask (tombstones False)

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]


@dataclasses.dataclass
class Int8StoreState:
    """The compressed corpus as device tensors: no [cap, dim] f32 matrix
    exists (at 10M x 512 the int8 rows are 5.1 GB where f32 would be 20 GB).
    Row n ~ scales[n] * int8(packed[n]) (+ rscales[n] * int8(resid[n]))."""

    packed: torch.Tensor   # [cap, dim/4] int32, four int8 dims per word
    scales: torch.Tensor   # [cap] float32 per-row dequantization scales
    ids: torch.Tensor      # [cap] int32 external ids, -1 for empty slots
    norms: torch.Tensor    # [cap] float32 EXACT squared norms (f32 at write)
    valid: torch.Tensor    # [cap] bool live-slot mask
    resid: Optional[torch.Tensor] = None    # [cap, dim/4] int32 residual
    rscales: Optional[torch.Tensor] = None  # [cap] float32

    @property
    def capacity(self) -> int:
        return self.packed.shape[0]

    @property
    def dim(self) -> int:
        return self.packed.shape[1] * 4


def init_store(capacity: int, dim: int, device, raw: bool = True,
               residual: bool = False):
    """Zeroed state at a capacity rounded up to 128; the compressed store
    rounds it on to 2048, so the packed pool kernel's width (<= 2048)
    always divides it and it never pad-copies the packed rows."""
    cap = _round_up(max(capacity, 128), 128)
    if not raw:
        if dim % 4 != 0:
            raise ValueError(
                f"compressed store requires dim % 4 == 0, got {dim}")
        cap = _round_up(cap, 2048)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)
        return Int8StoreState(
            packed=zeros(cap, dim // 4, dtype=torch.int32), scales=zeros(cap),
            ids=torch.full((cap,), -1, dtype=torch.int32, device=device),
            norms=zeros(cap), valid=zeros(cap, dtype=torch.bool),
            resid=zeros(cap, dim // 4, dtype=torch.int32) if residual else None,
            rscales=zeros(cap) if residual else None)
    if residual:
        raise ValueError("residual refine rows require raw=False "
                         "(the raw store's f32 rows are already exact)")
    return StoreState(
        vectors=torch.zeros((cap, dim), dtype=torch.float32, device=device),
        ids=torch.full((cap,), -1, dtype=torch.int32, device=device),
        norms=torch.zeros((cap,), dtype=torch.float32, device=device),
        valid=torch.zeros((cap,), dtype=torch.bool, device=device),
    )


class VectorStore:
    """Host slot allocator over a device StoreState.

    ``version`` counts writes; index caches derived from the rows (the
    int8 scan shadows, the packed refine stores) compare it to know whether
    they are current.  ``raw=False`` holds the compressed tier
    (``residual`` adds its second int8 level).
    """

    def __init__(self, capacity: int, dim: int, raw: bool = True,
                 device="cuda", residual: bool = False):
        if dim <= 0:
            raise ValueError(f"dim must be positive, got {dim}")
        self.raw = raw
        self.device = resolve_device(device)
        self.state = init_store(capacity, dim, self.device, raw, residual)
        self.dim = dim
        self.version = 0
        self._id_to_slot: dict[int, int] = {}
        self._free: list[int] = list(range(self.state.capacity - 1, -1, -1))

    # ------------------------------------------------------------- properties
    @property
    def capacity(self) -> int:
        return self.state.capacity

    def __len__(self) -> int:
        return len(self._id_to_slot)

    def size(self) -> int:
        return len(self._id_to_slot)

    def contains(self, vec_id: int) -> bool:
        return vec_id in self._id_to_slot

    def slot_of(self, vec_id: int) -> Optional[int]:
        return self._id_to_slot.get(vec_id)

    def ids(self) -> list[int]:
        return list(self._id_to_slot.keys())

    # -------------------------------------------------------------- mutation
    def add_batch(self, ids: Sequence[int], vecs) -> tuple[list[int], list[int]]:
        """Insert a batch ([n, dim] numpy array or tensor). Returns (accepted
        external ids, assigned slots); duplicate ids, negative ids and rows
        past capacity are rejected per row."""
        vecs = torch.as_tensor(vecs, dtype=torch.float32)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(
                f"expected [*, {self.dim}] vectors, got {tuple(vecs.shape)}")
        take_ids: list[int] = []
        take_rows: list[int] = []
        slots: list[int] = []
        for row, vid in enumerate(ids):
            vid = int(vid)
            if vid < 0 or vid in self._id_to_slot or not self._free:
                continue
            slot = self._free.pop()
            self._id_to_slot[vid] = slot
            take_ids.append(vid)
            take_rows.append(row)
            slots.append(slot)
        if not take_ids:
            return [], []
        # padded to a power of two like the reference (bounded write shapes);
        # pad rows repeat the last real row, so the scatter is idempotent
        n = len(take_ids)
        pad = (1 << (n - 1).bit_length()) - n
        dev = self.device
        slot_t = torch.tensor(slots + [slots[-1]] * pad, dtype=torch.long,
                              device=dev)
        id_t = torch.tensor(take_ids + [take_ids[-1]] * pad,
                            dtype=torch.int32, device=dev)
        rows_t = torch.tensor(take_rows + [take_rows[-1]] * pad,
                              dtype=torch.long, device=vecs.device)
        self._write(slot_t, id_t, vecs[rows_t].to(dev))
        return take_ids, slots

    def _write(self, slots, ids: torch.Tensor, rows: torch.Tensor) -> None:
        """Write f32 rows into ``slots`` (an index tensor or a slice): the
        raw rows, or their int8 packing (+ residual) with exact norms."""
        st = self.state
        st.ids[slots] = ids
        st.norms[slots] = torch.sum(rows * rows, dim=-1)
        st.valid[slots] = True
        if self.raw:
            st.vectors[slots] = rows
        else:
            packed, scales = pack_int8_rows(rows)
            st.packed[slots] = packed
            st.scales[slots] = scales
            if st.resid is not None:
                st.resid[slots], st.rscales[slots] = pack_int8_residual(
                    rows, packed, scales)
        self.version += 1

    def add(self, vec_id: int, vec) -> Optional[int]:
        accepted, slots = self.add_batch(
            [vec_id], torch.as_tensor(vec, dtype=torch.float32)[None, :])
        return slots[0] if accepted else None

    def bulk_load(self, ids: Sequence[int], vectors) -> list[int]:
        """Bulk ingest of an [n, dim] corpus (ideally already on the store's
        device) into an empty store; rows land in slots 0..n-1."""
        if self._id_to_slot:
            raise ValueError("bulk_load requires an empty store")
        vectors = torch.as_tensor(vectors, dtype=torch.float32)
        n = vectors.shape[0]
        if vectors.ndim != 2 or n > self.capacity or vectors.shape[1] != self.dim:
            raise ValueError(
                f"bulk_load shape {tuple(vectors.shape)} exceeds store")
        ids_np = np.asarray(ids, dtype=np.int64).reshape(-1)
        if len(ids_np) != n:
            raise ValueError("ids/vectors length mismatch")
        if (ids_np < 0).any() or np.unique(ids_np).size != n:
            raise ValueError("bulk_load ids must be unique and non-negative")
        st = self.state
        for f in dataclasses.fields(st):
            if getattr(st, f.name) is not None:
                getattr(st, f.name).zero_()
        st.ids.fill_(-1)
        self._write(slice(0, n), torch.as_tensor(
            ids_np.astype(np.int32), device=self.device),
            vectors.to(self.device))
        self._id_to_slot = {int(v): i for i, v in enumerate(ids_np.tolist())}
        self._free = list(range(self.capacity - 1, n - 1, -1))
        return ids_np.tolist()

    def write_range(self, start: int, ids: np.ndarray,
                    vectors: torch.Tensor) -> None:
        """Write rows into the contiguous slots [start, start + n) and map
        their ids (streamed ingest; the caller validates and keeps the
        freelist)."""
        n = vectors.shape[0]
        self._write(slice(start, start + n), torch.as_tensor(
            ids.astype(np.int32), device=self.device), vectors)
        self._id_to_slot.update(zip(ids.tolist(), range(start, start + n)))

    def rows(self, slots) -> torch.Tensor:
        """Device rows [len(slots), dim] f32 for the given slots: raw rows,
        or the compressed rows dequantized (plus the residual level).  The
        compressed tier's only f32 view: call it on samples and chunks,
        never on the whole store."""
        sl = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        st = self.state
        if self.raw:
            return st.vectors[sl]
        out = unpack_int8_rows(st.packed[sl], st.scales[sl])
        if st.resid is not None:
            out = out + unpack_int8_rows(st.resid[sl], st.rscales[sl])
        return out

    def remove(self, vec_id: int) -> Optional[int]:
        """Tombstone delete. Returns the freed slot, or None if absent."""
        slot = self._id_to_slot.pop(int(vec_id), None)
        if slot is None:
            return None
        self.state.ids[slot] = -1
        self.state.valid[slot] = False
        self._free.append(slot)
        self.version += 1
        return slot

    def get(self, vec_id: int) -> Optional[np.ndarray]:
        slot = self._id_to_slot.get(int(vec_id))
        if slot is None:
            return None
        return self.rows([slot])[0].cpu().numpy()

    # ---------------------------------------------------------- persistence
    def to_host(self) -> dict:
        """Numpy snapshot with the reference's keys (checkpoint format):
        ``vectors`` for the raw store, ``packed8``/``scales8`` (+
        ``resid8``/``rscales8``) for the compressed one."""
        st = self.state
        out = {"ids": st.ids.cpu().numpy(), "norms": st.norms.cpu().numpy(),
               "valid": st.valid.cpu().numpy()}
        if self.raw:
            out["vectors"] = st.vectors.cpu().numpy()
        else:
            out["packed8"] = st.packed.cpu().numpy()
            out["scales8"] = st.scales.cpu().numpy()
            if st.resid is not None:
                out["resid8"] = st.resid.cpu().numpy()
                out["rscales8"] = st.rscales.cpu().numpy()
        return out

    @classmethod
    def from_host(cls, arrays: dict, device="cuda") -> "VectorStore":
        """Inverse of :meth:`to_host`; accepts the reference's snapshot of
        either store."""
        st = cls.__new__(cls)
        st.device = resolve_device(device)
        st.raw = "vectors" in arrays

        def dev(key, dtype):
            return torch.tensor(np.asarray(arrays[key], dtype),
                                device=st.device)
        ids = np.asarray(arrays["ids"], np.int32)
        valid = np.asarray(arrays["valid"], bool)
        common = dict(ids=dev("ids", np.int32), norms=dev("norms", np.float32),
                      valid=dev("valid", bool))
        if st.raw:
            st.state = StoreState(vectors=dev("vectors", np.float32), **common)
        else:
            resid = "resid8" in arrays
            st.state = Int8StoreState(
                packed=dev("packed8", np.int32),
                scales=dev("scales8", np.float32), **common,
                resid=dev("resid8", np.int32) if resid else None,
                rscales=dev("rscales8", np.float32) if resid else None)
        st.dim = st.state.dim
        cap = st.state.capacity
        st.version = 0
        st._id_to_slot = {int(i): s for s, i in enumerate(ids) if valid[s]}
        st._free = [s for s in range(cap - 1, -1, -1) if not valid[s]]
        return st
