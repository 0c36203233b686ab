"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(the counterpart of ``vector_db_tpu/ops/pallas_kernels.py``).

``fused_int8_pool`` replaces the TPU kernel of the same name
(``vector_db_tpu/ops/pallas_kernels.py:585``).  Its CUDA source is
``vector_db_torch/csrc/fused_int8_pool.cu``; the source's header says what
bounds it on an H100 and how it is laid out.

Dispatch is on the tensor's device and nothing else: a CPU tensor goes to
the plain version, a CUDA tensor to the kernel, which is built from the
checkout's source with ``nvcc`` at first use (into ``build/torch_kernels/``
beside the package, keyed by the source's hash) and loaded with ctypes.  A
missing ``nvcc``, a failed build and a failed launch raise; no path sends a
CUDA tensor to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import torch

LANES = 128
#: the reference kernel's column block; the pool width rounds to a multiple
#: of min(BLOCK_N, max(128, w))
BLOCK_N = 512
#: bytes of [Q, passes * w] scores one chunk of the plain version holds
PLAIN_CHUNK_BYTES = 256 << 20
#: the largest row width the kernel's shared-memory tiles hold on an H100,
#: and the largest at which the int32 cross term stays below 2^24 (exact
#: in f32): 127^2 * 1040 < 2^24
MAX_INT8_POOL_DIM = 1040

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"


# ------------------------------------------------------------------- build
class _Library:
    """The kernels' shared library, built once per process and source hash."""

    def __init__(self):
        self.lib: Optional[ctypes.CDLL] = None
        self.path: Optional[Path] = None
        self.build_log = ""
        self.build_seconds = 0.0

    def get(self) -> ctypes.CDLL:
        if self.lib is None:
            self._load()
        return self.lib

    def _load(self) -> None:
        import time

        from torch.utils.cpp_extension import CUDA_HOME

        sources = sorted(_CSRC.glob("*.cu"))
        digest = hashlib.sha256()
        for src in sources:
            digest.update(src.read_bytes())
        out = BUILD_DIR / f"libvdb_torch_kernels_{digest.hexdigest()[:16]}.so"
        log_path = out.with_suffix(".log")
        if not out.exists():
            nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
            if not CUDA_HOME or not os.path.exists(nvcc):
                raise RuntimeError(
                    "nvcc not found (CUDA_HOME is unset or has no bin/nvcc); "
                    "the CUDA kernels cannot be built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                   "-Xcompiler", "-fPIC", "-o", str(tmp),
                   *[str(s) for s in sources]]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_seconds = time.perf_counter() - t0
            log_path.write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)
        self.build_log = log_path.read_text() if log_path.exists() else ""
        lib = ctypes.CDLL(str(out))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.vdb_fused_int8_pool.argtypes = [ptr] * 9 + [i32] * 5 + [ptr]
        lib.vdb_fused_int8_pool.restype = i32
        lib.vdb_int8_pool_smem_bytes.argtypes = [i32]
        lib.vdb_int8_pool_smem_bytes.restype = i32
        lib.vdb_cuda_error_string.argtypes = [i32]
        lib.vdb_cuda_error_string.restype = ctypes.c_char_p
        self.lib, self.path = lib, out


LIBRARY = _Library()


def build_kernels() -> _Library:
    """Build (if needed) and load the kernel library; returns it, with its
    path, the compiler's log and the build time."""
    LIBRARY.get()
    return LIBRARY


# ------------------------------------------------------- fused_int8_pool
def pool_width(w: int) -> int:
    """The pool width the reference's kernel returns for a requested ``w``:
    rounded up to 128, then to a multiple of min(512, max(128, w))."""
    w_aligned = -(-w // LANES) * LANES
    block_n = min(BLOCK_N, max(LANES, w_aligned))
    return -(-w_aligned // block_n) * block_n


def _quantize_rows_int8(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: (q8 int8, sq f32) with
    sq = max(max|q_i|, 1e-12) / 127 and q8 = round-half-even(q / sq)."""
    sq = torch.clamp(torch.amax(torch.abs(q), dim=1), min=1e-12) / 127.0
    q8 = torch.clamp(torch.round(q / sq[:, None]), -127, 127).to(torch.int8)
    return q8, sq


def _pad_cols(q8: torch.Tensor, d: int) -> torch.Tensor:
    """Zero columns up to the shadow's width (the shadow builder pads rows
    to a multiple of 4 bytes; zeros add nothing to a dot)."""
    if q8.shape[1] == d:
        return q8
    return torch.nn.functional.pad(q8, (0, d - q8.shape[1]))


def _check_pool_args(q, base8, sel_off, sel_scale):
    n, d = base8.shape
    if q.ndim != 2 or q.shape[1] > d:
        raise ValueError(f"queries {tuple(q.shape)} wider than shadow {d}")
    if base8.dtype != torch.int8:
        raise TypeError(f"base8 must be int8, got {base8.dtype}")
    if sel_off.shape != (n,) or sel_scale.shape != (n,):
        raise ValueError("sel_off/sel_scale must be [N] like base8's rows")
    if d > MAX_INT8_POOL_DIM:
        raise ValueError(f"row width {d} > {MAX_INT8_POOL_DIM}: the int32 "
                         "cross term would not be exact in f32")


def fused_int8_pool_plain(q: torch.Tensor, base8: torch.Tensor,
                          sel_off: torch.Tensor, sel_scale: torch.Tensor,
                          w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_int8_pool`, on any device.

    The cross term is an f32 matmul of the int8 values: every partial sum
    is an integer below 2^24 (d <= 1040), so it is exact with TF32 off.
    Passes go in chunks of at most ``PLAIN_CHUNK_BYTES`` of [Q, passes * w]
    scores, so the [Q, N] product never exists whole.
    """
    _check_pool_args(q, base8, sel_off, sel_scale)
    n, d = base8.shape
    w = pool_width(w)
    q8, sq = _quantize_rows_int8(q.to(torch.float32))
    qf = _pad_cols(q8, d).to(torch.float32)
    qn = q.shape[0]
    dev = q.device
    vals = torch.full((qn, w), float("inf"), device=dev)
    slots = torch.full((qn, w), -1, dtype=torch.int32, device=dev)
    passes = -(-n // w)
    per_chunk = max(1, PLAIN_CHUNK_BYTES // max(1, 4 * qn * w))
    cols = torch.arange(w, dtype=torch.int32, device=dev)
    for p0 in range(0, passes, per_chunk):
        p1 = min(passes, p0 + per_chunk)
        r0, r1 = p0 * w, min(n, p1 * w)
        cross = qf @ base8[r0:r1].to(torch.float32).T            # [Q, rows]
        score = sel_off[None, r0:r1] + (cross * sel_scale[None, r0:r1]) * sq[:, None]
        if r1 - r0 < (p1 - p0) * w:  # ragged last pass: missing slots +inf
            score = torch.nn.functional.pad(
                score, (0, (p1 - p0) * w - (r1 - r0)), value=float("inf"))
        score = score.view(qn, p1 - p0, w)
        for j in range(p1 - p0):
            s = score[:, j]
            better = s < vals  # strict: the earliest pass keeps a tie
            vals = torch.where(better, s, vals)
            slots = torch.where(better, cols + (p0 + j) * w, slots)
    slots = torch.where(torch.isfinite(vals), slots, torch.full_like(slots, -1))
    return vals, slots


def fused_int8_pool(q: torch.Tensor, base8: torch.Tensor,
                    sel_off: torch.Tensor, sel_scale: torch.Tensor,
                    w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused s8 x s8 scan + strided-bucket min pool over an int8 shadow.

    q [Q, d] f32, pre-centered by the caller, quantized here per row to
    int8; base8 [N, d8] int8 (d8 >= d, d8 % 4 == 0 on CUDA; the extra
    columns are the shadow's zero padding); sel_off [N] f32 (+inf at dead
    slots); sel_scale [N] f32.  The score of slot n is
    ``off[n] + (q8 . v8_n) * sel_scale[n] * sq[q]``.  Returns an unranked
    pool: vals [Q, W] f32 and slots [Q, W] int32 (-1 where empty), where
    column c holds the best of slots c, c + W, c + 2W, ... and W is
    :func:`pool_width` (w).

    A CPU tensor runs :func:`fused_int8_pool_plain`; a CUDA tensor runs
    the kernel (``csrc/fused_int8_pool.cu``) and counts one launch in
    ``fused_int8_pool.launches``.
    """
    if q.device.type == "cpu":
        return fused_int8_pool_plain(q, base8, sel_off, sel_scale, w)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_pool_args(q, base8, sel_off, sel_scale)
    n, d = base8.shape
    for name, t in (("base8", base8), ("sel_off", sel_off),
                    ("sel_scale", sel_scale)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, queries on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sel_off.dtype != torch.float32 or sel_scale.dtype != torch.float32:
        raise TypeError("sel_off/sel_scale must be float32")
    if d % 4 != 0 or base8.data_ptr() % 4 != 0:
        raise ValueError("base8 rows must be whole 4-byte words (d % 4 == 0)")
    w = pool_width(w)
    qn = q.shape[0]
    vals = torch.empty((qn, w), dtype=torch.float32, device=q.device)
    slots = torch.empty((qn, w), dtype=torch.int32, device=q.device)
    if qn == 0:
        return vals, slots
    q8, sq = _quantize_rows_int8(q.to(torch.float32))
    q8 = _pad_cols(q8, d).contiguous()
    sq = sq.contiguous()
    lib = LIBRARY.get()
    # split the passes over blocks when the query x column tiles alone
    # leave the card's SMs idle (the partial pools merge in pass order)
    passes = -(-n // w) if n else 0
    tiles = (w // LANES) * -(-qn // 64)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = max(1, min(passes, -(-4 * sms // tiles)))
    if splits > 1:
        part_v = torch.empty((splits, qn, w), dtype=torch.float32,
                             device=q.device)
        part_s = torch.empty((splits, qn, w), dtype=torch.int32,
                             device=q.device)
    else:
        part_v = part_s = vals
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vdb_fused_int8_pool(
            q8.data_ptr(), sq.data_ptr(), base8.data_ptr(),
            sel_off.data_ptr(), sel_scale.data_ptr(), part_v.data_ptr(),
            part_s.data_ptr(), vals.data_ptr(), slots.data_ptr(),
            qn, n, d, w, splits, stream)
    if rc != 0:
        msg = lib.vdb_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_int8_pool launch failed: {msg} ({rc})")
    fused_int8_pool.launches += 1
    return vals, slots


fused_int8_pool.launches = 0
