"""Python binding for the native storage engine (libvdbstore.so).

A copy of ``vector_db_tpu/storage/native.py``: both packages share the C++
engine in ``native/`` (an append-only CRC-guarded WAL + snapshot), so a WAL
written by either package replays in the other.

Binding is ctypes.  When the shared library is absent (``make -C native``
builds it), a pure-Python engine implements the IDENTICAL on-disk format
(zlib.crc32 is the same CRC-32 polynomial), so files written by either side
are readable by the other.
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import zlib
from typing import Optional

import numpy as np

logger = logging.getLogger("vector_db_torch.storage")

WAL_MAGIC = 0x56444257
SNAP_MAGIC = 0x56444253
FORMAT_VERSION = 1
REC_ADD = 1
REC_DELETE = 2

_WAL_HEADER = struct.Struct("<IIII")
_REC_HEADER = struct.Struct("<IiII")
_SNAP_HEADER = struct.Struct("<IIIII")

#: durability policy for acknowledged mutations, weakest to strongest:
#: "buffered" — user-space buffers; durable only at flush/snapshot/close
#:              (the reference's write-behind guarantee, VectorStorage.java:81)
#: "flush"    — flush per append call; survives process crash (kill -9)
#: "fsync"    — flush + fsync per append call; survives OS crash
DURABILITY_LEVELS = {"buffered": 0, "flush": 1, "fsync": 2}


def _durability_level(durability: str) -> int:
    if durability not in DURABILITY_LEVELS:
        raise ValueError(
            f"durability must be one of {sorted(DURABILITY_LEVELS)}, got {durability!r}"
        )
    return DURABILITY_LEVELS[durability]


def _find_library() -> Optional[str]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates = [
        os.environ.get("VDBSTORE_NATIVE_PATH"),
        os.path.join(here, "native", "build", "libvdbstore.so"),
        os.path.join(here, "native", "build", "Release", "libvdbstore.so"),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def _load_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = _find_library()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.vdb_open.restype = ctypes.c_int64
    lib.vdb_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
    lib.vdb_append_add.restype = ctypes.c_int32
    lib.vdb_append_add.argtypes = [ctypes.c_int64, ctypes.c_int32,
                                   ctypes.POINTER(ctypes.c_float)]
    lib.vdb_append_add_batch.restype = ctypes.c_int32
    lib.vdb_append_add_batch.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
    ]
    lib.vdb_append_delete.restype = ctypes.c_int32
    lib.vdb_append_delete.argtypes = [ctypes.c_int64, ctypes.c_int32]
    try:
        lib.vdb_set_durability.restype = ctypes.c_int32
        lib.vdb_set_durability.argtypes = [ctypes.c_int64, ctypes.c_int32]
    except AttributeError:  # pre-durability library build
        pass
    lib.vdb_flush.restype = ctypes.c_int32
    lib.vdb_flush.argtypes = [ctypes.c_int64]
    lib.vdb_snapshot.restype = ctypes.c_int32
    lib.vdb_snapshot.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.c_uint32,
    ]
    lib.vdb_load.restype = ctypes.c_int32
    lib.vdb_load.argtypes = [
        ctypes.c_int64, ctypes.c_uint32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.vdb_close.restype = ctypes.c_int32
    lib.vdb_close.argtypes = [ctypes.c_int64]
    _LIB = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


class NativeStorageEngine:
    """ctypes wrapper over libvdbstore."""

    def __init__(self, path: str, dim: int, durability: str = "flush"):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("libvdbstore.so not found (build with make -C native)")
        self._lib = lib
        self.dim = dim
        self.path = path
        self.durability = durability
        self._h = lib.vdb_open(path.encode(), dim)
        if self._h <= 0:
            raise RuntimeError(f"vdb_open failed for {path}")
        if hasattr(lib, "vdb_set_durability"):
            lib.vdb_set_durability(self._h, _durability_level(durability))

    def append_add(self, vec_id: int, vec: np.ndarray) -> bool:
        vec = np.ascontiguousarray(vec, np.float32)
        ptr = vec.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        return bool(self._lib.vdb_append_add(self._h, int(vec_id), ptr))

    def append_add_batch(self, ids: np.ndarray, vecs: np.ndarray) -> int:
        ids = np.ascontiguousarray(ids, np.int32)
        vecs = np.ascontiguousarray(vecs, np.float32)
        rc = int(self._lib.vdb_append_add_batch(
            self._h,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            vecs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(ids),
        ))
        if rc < 0:
            # -w: w records reached the stream but the durability commit
            # failed.  They may still land at close, so a retry would write
            # duplicates — report the write as accepted but degraded.
            logger.warning(
                "WAL durability commit failed for %d appended records "
                "(records buffered; durability degraded to write-behind)",
                -rc,
            )
            return -rc
        return rc

    def append_delete(self, vec_id: int) -> bool:
        return bool(self._lib.vdb_append_delete(self._h, int(vec_id)))

    def flush(self) -> bool:
        return bool(self._lib.vdb_flush(self._h))

    def snapshot(self, ids: np.ndarray, vecs: np.ndarray) -> bool:
        ids = np.ascontiguousarray(ids, np.int32)
        vecs = np.ascontiguousarray(vecs, np.float32)
        return bool(self._lib.vdb_snapshot(
            self._h,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            vecs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(ids),
        ))

    def load(self, max_n: int) -> tuple[np.ndarray, np.ndarray]:
        out_ids = np.empty(max_n, np.int32)
        out_vecs = np.empty((max_n, self.dim), np.float32)
        n = self._lib.vdb_load(
            self._h, max_n,
            out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_vecs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if n < 0:
            raise RuntimeError("vdb_load failed")
        return out_ids[:n].copy(), out_vecs[:n].copy()

    def close(self) -> None:
        if self._h > 0:
            self._lib.vdb_close(self._h)
            self._h = 0


class PyStorageEngine:
    """Pure-Python fallback writing the identical on-disk format."""

    def __init__(self, path: str, dim: int, durability: str = "flush"):
        self.path = path
        self.dim = dim
        self.durability = durability
        self._level = _durability_level(durability)
        os.makedirs(path, exist_ok=True)
        self._wal_path = os.path.join(path, "wal.bin")
        self._snap_path = os.path.join(path, "snapshot.bin")
        if not os.path.exists(self._wal_path) or os.path.getsize(self._wal_path) == 0:
            with open(self._wal_path, "wb") as f:
                f.write(_WAL_HEADER.pack(WAL_MAGIC, FORMAT_VERSION, dim, 0))
        self._wal = open(self._wal_path, "ab")

    @staticmethod
    def _crc(type_id_bytes: bytes, payload: bytes) -> int:
        c = zlib.crc32(type_id_bytes)
        if payload:
            c = zlib.crc32(payload, c)
        return c & 0xFFFFFFFF

    def _write(self, rtype: int, vec_id: int, payload: bytes) -> bool:
        head8 = struct.pack("<Ii", rtype, vec_id)
        crc = self._crc(head8, payload)
        self._wal.write(_REC_HEADER.pack(rtype, vec_id, len(payload), crc))
        self._wal.write(payload)
        return True

    def _commit(self) -> None:
        """Apply the durability policy after an append call (batches commit
        as one group — the small-group flush policy)."""
        if self._level >= 1:
            self._wal.flush()
        if self._level >= 2:
            os.fsync(self._wal.fileno())

    def append_add(self, vec_id: int, vec: np.ndarray) -> bool:
        ok = self._write(REC_ADD, int(vec_id),
                         np.ascontiguousarray(vec, np.float32).tobytes())
        self._commit()
        return ok

    def append_add_batch(self, ids: np.ndarray, vecs: np.ndarray) -> int:
        vecs = np.ascontiguousarray(vecs, np.float32)
        for i, vid in enumerate(ids):
            self._write(REC_ADD, int(vid), vecs[i].tobytes())
        self._commit()
        return len(ids)

    def append_delete(self, vec_id: int) -> bool:
        ok = self._write(REC_DELETE, int(vec_id), b"")
        self._commit()
        return ok

    def flush(self) -> bool:
        self._wal.flush()
        if self._level >= 2:
            os.fsync(self._wal.fileno())
        return True

    def snapshot(self, ids: np.ndarray, vecs: np.ndarray) -> bool:
        ids = np.ascontiguousarray(ids, np.int32)
        vecs = np.ascontiguousarray(vecs, np.float32)
        crc = zlib.crc32(ids.tobytes())
        crc = zlib.crc32(vecs.tobytes(), crc) & 0xFFFFFFFF
        tmp = self._snap_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_SNAP_HEADER.pack(SNAP_MAGIC, FORMAT_VERSION, self.dim,
                                      len(ids), crc))
            f.write(ids.tobytes())
            f.write(vecs.tobytes())
            if self._level >= 2:
                f.flush()
                os.fsync(f.fileno())  # payload durable BEFORE the rename
        os.replace(tmp, self._snap_path)
        if self._level >= 2:  # make the rename durable (directory entry)
            dfd = os.open(os.path.dirname(self._snap_path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        self._wal.close()
        with open(self._wal_path, "wb") as f:
            f.write(_WAL_HEADER.pack(WAL_MAGIC, FORMAT_VERSION, self.dim, 0))
            if self._level >= 2:
                f.flush()
                os.fsync(f.fileno())
        self._wal = open(self._wal_path, "ab")
        return True

    def load(self, max_n: int) -> tuple[np.ndarray, np.ndarray]:
        live: dict[int, np.ndarray] = {}
        if os.path.exists(self._snap_path):
            with open(self._snap_path, "rb") as f:
                head = f.read(_SNAP_HEADER.size)
                if len(head) == _SNAP_HEADER.size:
                    magic, ver, dim, count, crc = _SNAP_HEADER.unpack(head)
                    if magic == SNAP_MAGIC and dim == self.dim:
                        ids_b = f.read(count * 4)
                        vecs_b = f.read(count * dim * 4)
                        c = zlib.crc32(ids_b)
                        c = zlib.crc32(vecs_b, c) & 0xFFFFFFFF
                        if c == crc and len(ids_b) == count * 4:
                            ids = np.frombuffer(ids_b, np.int32)
                            vecs = np.frombuffer(vecs_b, np.float32).reshape(count, dim)
                            for i, vid in enumerate(ids):
                                live[int(vid)] = vecs[i]
        self.flush()
        with open(self._wal_path, "rb") as f:
            head = f.read(_WAL_HEADER.size)
            if len(head) == _WAL_HEADER.size:
                magic, ver, dim, _ = _WAL_HEADER.unpack(head)
                if magic == WAL_MAGIC and dim == self.dim:
                    while True:
                        rec = f.read(_REC_HEADER.size)
                        if len(rec) < _REC_HEADER.size:
                            break
                        rtype, vid, plen, crc = _REC_HEADER.unpack(rec)
                        payload = f.read(plen)
                        if len(payload) < plen:
                            break  # torn write
                        if self._crc(rec[:8], payload) != crc:
                            break  # corrupt record
                        if rtype == REC_ADD and plen == self.dim * 4:
                            live[vid] = np.frombuffer(payload, np.float32)
                        elif rtype == REC_DELETE:
                            live.pop(vid, None)
        items = sorted(live.items())[:max_n]
        if not items:
            return np.empty(0, np.int32), np.empty((0, self.dim), np.float32)
        ids = np.asarray([i for i, _ in items], np.int32)
        vecs = np.stack([v for _, v in items]).astype(np.float32)
        return ids, vecs

    def close(self) -> None:
        if not self._wal.closed:
            self._wal.flush()
            self._wal.close()


def load_status() -> dict:
    """Diagnostic dump of the native-library resolution (reference:
    jni/NativeLoader.getLoadStatus :224-244)."""
    path = _find_library()
    return {
        "native_available": native_available(),
        "library_path": path,
        "env_override": os.environ.get("VDBSTORE_NATIVE_PATH"),
        "fallback": "PyStorageEngine (identical on-disk format)",
        "format_version": FORMAT_VERSION,
    }


def open_engine(path: str, dim: int, prefer_native: bool = True,
                durability: str = "flush"):
    """Open the native engine if the library is available, else the
    format-compatible Python fallback.  ``durability`` is one of
    "buffered" | "flush" (default) | "fsync" — see DURABILITY_LEVELS."""
    if prefer_native and native_available():
        return NativeStorageEngine(path, dim, durability)
    return PyStorageEngine(path, dim, durability)
