"""Checkpointed persistence — save/load of index state as host arrays.

The format of ``vector_db_tpu/storage/checkpoint.py``: ``<dir>/meta.json`` +
``<dir>/arrays.npz`` (nested dicts flattened with ``/`` separators), so a
checkpoint the JAX package wrote loads here.  A temp file + atomic rename
keeps the checkpoint crash-consistent.  ``save_checkpoint_streamed`` and
``open_checkpoint_lazy`` write and read the same files one member at a
time, for payloads larger than host memory (the sharded tier).
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile

import numpy as np
from numpy.lib import format as npformat

_SEP = "/"


def _flatten(prefix: str, tree: dict, out: dict) -> None:
    for key, val in tree.items():
        name = f"{prefix}{_SEP}{key}" if prefix else str(key)
        if isinstance(val, dict):
            _flatten(name, val, out)
        else:
            out[name] = np.asarray(val)


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for name, val in flat.items():
        parts = name.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _atomic_write(path: str, final: str, suffix: str, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=path, suffix=suffix)
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, os.path.join(path, final))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(path: str, meta: dict, arrays: dict) -> None:
    """Atomically write meta.json + arrays.npz under ``path`` (arrays are
    nested dicts of numpy arrays)."""
    os.makedirs(path, exist_ok=True)
    flat: dict[str, np.ndarray] = {}
    _flatten("", arrays, flat)

    def write_npz(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, **flat)

    def write_meta(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)

    _atomic_write(path, "arrays.npz", ".npz.tmp", write_npz)
    _atomic_write(path, "meta.json", ".json.tmp", write_meta)


def load_checkpoint(path: str) -> tuple[dict, dict] | None:
    """Load (meta, arrays) or None if no checkpoint exists / it is corrupt
    (a corrupt checkpoint degrades to an empty database)."""
    meta_path = os.path.join(path, "meta.json")
    npz_path = os.path.join(path, "arrays.npz")
    if not (os.path.exists(meta_path) and os.path.exists(npz_path)):
        return None
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        with np.load(npz_path, allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
    except (json.JSONDecodeError, ValueError, OSError, KeyError):
        return None
    return meta, _unflatten(flat)


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, "meta.json"))


def save_checkpoint_streamed(path: str, meta: dict, arrays: dict,
                             lazy_arrays) -> None:
    """:func:`save_checkpoint` for payloads that never exist on the host in
    full (``parallel/sharded.py`` with ``host_mirror=False``):
    ``lazy_arrays`` is an iterable of ``(name, fn)`` pairs, each ``fn()``
    fetched and written straight into the zip one at a time, so peak host
    memory is the largest single lazy array.  The file is a standard npz
    (``ZIP_STORED``, zip64 members) that :func:`load_checkpoint` and numpy
    read."""
    os.makedirs(path, exist_ok=True)
    flat: dict[str, np.ndarray] = {}
    _flatten("", arrays, flat)

    def write_npz(tmp):
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            def member(name, arr):
                with zf.open(name + ".npy", "w", force_zip64=True) as f:
                    npformat.write_array(f, np.asarray(arr))

            for name, arr in flat.items():
                member(name, arr)
            for name, fetch in lazy_arrays:
                member(name, fetch())

    def write_meta(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)

    _atomic_write(path, "arrays.npz", ".npz.tmp", write_npz)
    _atomic_write(path, "meta.json", ".json.tmp", write_meta)


def open_checkpoint_lazy(path: str):
    """``(meta, npz)`` with each npz member read from disk on access (numpy
    ``NpzFile``): the restore path that holds one member in host memory at
    a time.  None when the checkpoint is absent or corrupt, like
    :func:`load_checkpoint`; the caller closes the npz."""
    meta_path = os.path.join(path, "meta.json")
    npz_path = os.path.join(path, "arrays.npz")
    if not (os.path.exists(meta_path) and os.path.exists(npz_path)):
        return None
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        z = np.load(npz_path, allow_pickle=False)
    except (json.JSONDecodeError, ValueError, OSError, KeyError,
            zipfile.BadZipFile):
        return None
    return meta, z
