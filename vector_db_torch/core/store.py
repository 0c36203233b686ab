"""Device-resident vector store — struct-of-arrays tensors on one device.

The counterpart of ``vector_db_tpu/core/store.py``, raw f32 tier.  The
arrays are preallocated at a capacity rounded up to 128 and updated IN
PLACE (the reference builds a new immutable pytree per write; here the
facade's reader-writer lock keeps searches off a store being written).

Slot management (id -> slot map, LIFO freelist) is host-side metadata and
assigns the same slots as the reference for the same sequence of adds and
removes, which is what lets a checkpoint cross-load.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

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


def init_store(capacity: int, dim: int, device) -> StoreState:
    cap = _round_up(max(capacity, 128), 128)
    return StoreState(
        vectors=torch.zeros((cap, dim), dtype=torch.float32, device=device),
        ids=torch.full((cap,), -1, dtype=torch.int32, device=device),
        norms=torch.zeros((cap,), dtype=torch.float32, device=device),
        valid=torch.zeros((cap,), dtype=torch.bool, device=device),
    )


class VectorStore:
    """Host slot allocator over a device StoreState.

    ``version`` counts writes; index caches derived from the rows (the
    int8 scan shadow) compare it to know whether they are current.
    """

    def __init__(self, capacity: int, dim: int, raw: bool = True,
                 device="cuda"):
        if dim <= 0:
            raise ValueError(f"dim must be positive, got {dim}")
        if not raw:
            raise NotImplementedError(
                "the compressed int8 store (raw_store=False) is not ported "
                "yet: ROADMAP A9"
            )
        self.raw = True
        self.device = resolve_device(device)
        self.state = init_store(capacity, dim, self.device)
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
        rows = vecs[rows_t].to(dev)
        st = self.state
        st.vectors[slot_t] = rows
        st.ids[slot_t] = id_t
        st.norms[slot_t] = torch.sum(rows * rows, dim=-1)
        st.valid[slot_t] = True
        self.version += 1
        return take_ids, slots

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
        st.vectors.zero_()
        st.vectors[:n] = vectors.to(self.device)
        st.ids.fill_(-1)
        st.ids[:n] = torch.as_tensor(ids_np.astype(np.int32), device=self.device)
        st.norms.copy_(torch.sum(st.vectors * st.vectors, dim=1))
        st.valid.copy_(st.ids >= 0)
        self._id_to_slot = {int(v): i for i, v in enumerate(ids_np.tolist())}
        self._free = list(range(self.capacity - 1, n - 1, -1))
        self.version += 1
        return ids_np.tolist()

    def rows(self, slots) -> torch.Tensor:
        """Device rows [len(slots), dim] f32 for the given slots."""
        sl = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        return self.state.vectors[sl]

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
        return self.state.vectors[slot].cpu().numpy()

    # ---------------------------------------------------------- persistence
    def to_host(self) -> dict:
        """Numpy snapshot with the reference's keys (checkpoint format)."""
        st = self.state
        return {
            "ids": st.ids.cpu().numpy(),
            "norms": st.norms.cpu().numpy(),
            "valid": st.valid.cpu().numpy(),
            "vectors": st.vectors.cpu().numpy(),
        }

    @classmethod
    def from_host(cls, arrays: dict, device="cuda") -> "VectorStore":
        """Inverse of :meth:`to_host`; accepts the reference's snapshot."""
        if "vectors" not in arrays:
            raise NotImplementedError(
                "checkpoint holds a compressed int8 store: ROADMAP A9")
        st = cls.__new__(cls)
        st.raw = True
        st.device = resolve_device(device)
        vecs = np.asarray(arrays["vectors"], np.float32)
        cap, st.dim = vecs.shape
        ids = np.asarray(arrays["ids"], np.int32)
        valid = np.asarray(arrays["valid"], bool)
        st.state = StoreState(
            vectors=torch.tensor(vecs, device=st.device),
            ids=torch.tensor(ids, device=st.device),
            norms=torch.tensor(np.asarray(arrays["norms"], np.float32),
                                  device=st.device),
            valid=torch.tensor(valid, device=st.device),
        )
        st.version = 0
        st._id_to_slot = {int(i): s for s, i in enumerate(ids) if valid[s]}
        st._free = [s for s in range(cap - 1, -1, -1) if not valid[s]]
        return st
