"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(the counterpart of ``vector_db_tpu/ops/pallas_kernels.py``).

Each function replaces the TPU kernel of the same name in
``vector_db_tpu/ops/pallas_kernels.py``:

  * ``fused_int8_pool`` (:585) and ``fused_packed_pool`` (:900), one CUDA
    kernel with two entry points, ``vector_db_torch/csrc/fused_int8_pool.cu``;
  * ``pq_decode_recon_t`` (:174), ``vector_db_torch/csrc/pq_decode.cu``.

Each source's header says what bounds it on an H100 and how it is laid out.

Dispatch is on the tensor's device and nothing else: a CPU tensor goes to
the plain version, a CUDA tensor to the kernel, which is built from the
checkout's sources with ``nvcc`` at first use (one compiler per source, in
parallel, into ``build/torch_kernels/`` beside the package, keyed by the
sources' hash) and loaded with ctypes.  A missing ``nvcc``, a failed build
and a failed launch raise; no path sends a CUDA tensor to the plain
version.  Each wrapper counts its kernel launches in ``<function>.launches``.
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
            tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
            objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            flags = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                     "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
            t0 = time.perf_counter()
            # one nvcc per source, all at once, then one link
            procs = [subprocess.Popen(
                [*flags, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(sources, objs)]
            logs = [p.communicate()[0] for p in procs]
            failed = [(src.name, p.returncode, log) for src, p, log
                      in zip(sources, procs, logs) if p.returncode != 0]
            if not failed:
                link = subprocess.run(
                    [*flags, "-shared", "-o", str(tmp), *map(str, objs)],
                    capture_output=True, text=True)
                logs.append(link.stdout + link.stderr)
                if link.returncode != 0:
                    failed.append(("link", link.returncode, link.stderr))
            self.build_seconds = time.perf_counter() - t0
            log_path.write_text("".join(logs))
            for obj in objs:
                obj.unlink(missing_ok=True)
            if failed:
                tmp.unlink(missing_ok=True)
                raise RuntimeError("nvcc failed:\n" + "\n".join(
                    f"{name} ({rc}):\n{log}" for name, rc, log in failed))
            os.replace(tmp, out)
        self.build_log = log_path.read_text() if log_path.exists() else ""
        lib = ctypes.CDLL(str(out))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for pool in (lib.vdb_fused_int8_pool, lib.vdb_fused_packed_pool):
            pool.argtypes = [ptr] * 9 + [i32] * 5 + [ptr]
            pool.restype = i32
        lib.vdb_pq_decode_recon_t.argtypes = ([ptr, i64, ptr, ptr]
                                              + [i32] * 4 + [ptr])
        lib.vdb_pq_decode_recon_t.restype = i32
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
    if base8.shape[1] % 4 != 0 or base8.data_ptr() % 4 != 0:
        raise ValueError("base8 rows must be whole 4-byte words (d % 4 == 0)")
    out = _launch_pool("vdb_fused_int8_pool", q, base8, sel_off, sel_scale,
                       pool_width(w), base8.shape[1])
    fused_int8_pool.launches += 1
    return out


fused_int8_pool.launches = 0


def _launch_pool(entry: str, q, base, sel_off, sel_scale, w: int, d: int):
    """Launch the pool kernel (``csrc/fused_int8_pool.cu``) through C entry
    ``entry`` over ``base``'s rows (int8 [N, d] or int32 words [N, d/4]):
    quantize and pad the queries, split the passes over blocks when the
    query x column tiles alone leave the card's SMs idle (the partial pools
    merge in pass order), raise if the launch fails."""
    n = base.shape[0]
    for name, t in (("base", base), ("sel_off", sel_off),
                    ("sel_scale", sel_scale)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, queries on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sel_off.dtype != torch.float32 or sel_scale.dtype != torch.float32:
        raise TypeError("sel_off/sel_scale must be float32")
    qn = q.shape[0]
    vals = torch.empty((qn, w), dtype=torch.float32, device=q.device)
    slots = torch.empty((qn, w), dtype=torch.int32, device=q.device)
    if qn == 0:
        return vals, slots
    q8, sq = _quantize_rows_int8(q.to(torch.float32))
    q8 = _pad_cols(q8, d).contiguous()
    sq = sq.contiguous()
    lib = LIBRARY.get()
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
        rc = getattr(lib, entry)(
            q8.data_ptr(), sq.data_ptr(), base.data_ptr(),
            sel_off.data_ptr(), sel_scale.data_ptr(), part_v.data_ptr(),
            part_s.data_ptr(), vals.data_ptr(), slots.data_ptr(),
            qn, n, d, w, splits, stream)
    _raise_on_error(lib, entry, rc)
    return vals, slots


def _raise_on_error(lib, entry: str, rc: int) -> None:
    if rc != 0:
        msg = lib.vdb_cuda_error_string(rc).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} ({rc})")


# ------------------------------------------------------- fused_packed_pool
def preserved_pool_width(n: int, max_w: int = 2048) -> int:
    """Largest pool width ``w <= max_w`` that divides ``n`` and that
    :func:`pool_width` leaves unchanged (``w <= 512`` or ``w % 512 == 0``):
    :func:`fused_packed_pool` refuses to pad-copy the packed store, so its
    callers pick their width here.  ``n`` must be a multiple of 128 (every
    store capacity is)."""
    if n % LANES:
        raise ValueError(f"store rows ({n}) must be a multiple of {LANES}")
    for w in range(min(max_w, n), 0, -LANES):
        if n % w == 0 and (w <= BLOCK_N or w % BLOCK_N == 0):
            return w
    return LANES


def _check_packed_args(q, packed, w: int) -> int:
    """Validate a packed-pool call; returns the rounded pool width."""
    n, dw = packed.shape
    if packed.dtype != torch.int32:
        raise TypeError(f"packed must be int32 words, got {packed.dtype}")
    if q.ndim != 2 or q.shape[1] != 4 * dw:
        raise ValueError(f"queries {tuple(q.shape)} do not match packed rows "
                         f"of {4 * dw} dims")
    if 4 * dw > MAX_INT8_POOL_DIM:
        raise ValueError(f"row width {4 * dw} > {MAX_INT8_POOL_DIM}: the "
                         "int32 cross term would not be exact in f32")
    w = pool_width(w)
    if n % w:
        raise ValueError(
            f"packed store rows ({n}) must be a multiple of the pool width "
            f"({w}); round the store capacity up (the compressed "
            "VectorStore rounds to 2048)")
    return w


def unpack_words_int8(packed: torch.Tensor) -> torch.Tensor:
    """[N, d/4] int32 words -> [N, d] int8 by explicit shifts: byte j of
    word c (bits 8j..8j+7, sign-extended) is dim 4c + j."""
    n, dw = packed.shape
    w32 = packed.to(torch.int32)
    parts = [(w32 << (24 - 8 * j)) >> 24 for j in range(4)]
    return torch.stack(parts, dim=2).reshape(n, 4 * dw).to(torch.int8)


def fused_packed_pool_plain(q: torch.Tensor, packed: torch.Tensor,
                            sel_off: torch.Tensor, sel_scale: torch.Tensor,
                            w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_packed_pool`, on any device:
    the words unpacked by shifts (:func:`unpack_words_int8`, which checks
    the byte order independently of ``Tensor.view``), then
    :func:`fused_int8_pool_plain`."""
    w = _check_packed_args(q, packed, w)
    return fused_int8_pool_plain(q, unpack_words_int8(packed), sel_off,
                                 sel_scale, w)


def fused_packed_pool(q: torch.Tensor, packed: torch.Tensor,
                      sel_off: torch.Tensor, sel_scale: torch.Tensor,
                      w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_int8_pool` directly over the compressed store's
    int32-packed int8 rows (no shadow copy).

    q [Q, d] f32 pre-centered by the caller, quantized here per row and
    NOT permuted (the words hold the dims in true order); packed [N, d/4]
    int32 (``ops/distance.pack_int8_rows``); sel_off [N] f32 (+inf at dead
    slots); sel_scale [N] f32.  N must be a multiple of the rounded
    ``w`` (:func:`preserved_pool_width`), else ``ValueError``: padding
    would copy the multi-GB store.  Returns the unranked pool like
    :func:`fused_int8_pool`.

    A CPU tensor runs :func:`fused_packed_pool_plain`; a CUDA tensor runs
    the pool kernel's packed entry point and counts one launch in
    ``fused_packed_pool.launches``.
    """
    if q.device.type == "cpu":
        return fused_packed_pool_plain(q, packed, sel_off, sel_scale, w)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    w = _check_packed_args(q, packed, w)
    n = packed.shape[0]
    if sel_off.shape != (n,) or sel_scale.shape != (n,):
        raise ValueError("sel_off/sel_scale must be [N] like packed's rows")
    out = _launch_pool("vdb_fused_packed_pool", q, packed, sel_off,
                       sel_scale, w, 4 * packed.shape[1])
    fused_packed_pool.launches += 1
    return out


fused_packed_pool.launches = 0


# ------------------------------------------------------- pq_decode_recon_t
def _check_decode_args(codes_t, cbt) -> tuple[int, int, int, int]:
    """(S, N, sd, K) of a decode call, or raise."""
    s, n = codes_t.shape
    d_aug, k = cbt.shape
    if d_aug % s:
        raise ValueError(f"cbt rows ({d_aug}) not a multiple of S={s}")
    if k > 2 * LANES:
        raise ValueError(f"K={k} > 256 is not supported")
    return s, n, d_aug // s, k


def pq_decode_recon_t_plain(codes_t: torch.Tensor,
                            cbt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`pq_decode_recon_t`, on any device:
    a gather of the codebook rows by code, then ``.to(torch.bfloat16)``."""
    s, n, sd, k = _check_decode_args(codes_t, cbt)
    idx = codes_t.long()[:, None, :].expand(s, sd, n)
    out = torch.gather(cbt.to(torch.float32).reshape(s, sd, k), 2, idx)
    return out.reshape(s * sd, n).to(torch.bfloat16)


def pq_decode_recon_t(codes_t: torch.Tensor, cbt: torch.Tensor) -> torch.Tensor:
    """Decode PQ codes to reconstructed vectors, transposed.

    codes_t [S, N] integer codes (uint8 as stored; on CUDA uint8 with unit
    column stride, so a column slice of a wider code matrix needs no copy);
    cbt [S*sd, K] f32 with cbt[s*sd + j, c] = codebooks[s, c, j], K <= 256.
    Returns reconT [S*sd, N] bf16, reconT[s*sd + j, n] =
    codebooks[s, codes[n, s], j] rounded to nearest even.

    A CPU tensor runs :func:`pq_decode_recon_t_plain`; a CUDA tensor runs
    the kernel (``csrc/pq_decode.cu``, bit-equal to the plain version) and
    counts one launch in ``pq_decode_recon_t.launches``.
    """
    if codes_t.device.type == "cpu":
        return pq_decode_recon_t_plain(codes_t, cbt)
    if codes_t.device.type != "cuda":
        raise ValueError(f"unsupported device {codes_t.device}")
    s, n, sd, k = _check_decode_args(codes_t, cbt)
    if codes_t.dtype != torch.uint8 or codes_t.stride(1) != 1:
        raise ValueError("codes_t must be uint8 with unit column stride")
    if cbt.device != codes_t.device or cbt.dtype != torch.float32 \
            or not cbt.is_contiguous():
        raise ValueError("cbt must be a contiguous float32 tensor on the "
                         "codes' device")
    out = torch.empty((s * sd, n), dtype=torch.bfloat16, device=codes_t.device)
    if n == 0:
        return out
    lib = LIBRARY.get()
    with torch.cuda.device(codes_t.device):
        stream = torch.cuda.current_stream(codes_t.device).cuda_stream
        rc = lib.vdb_pq_decode_recon_t(
            codes_t.data_ptr(), max(codes_t.stride(0), n), cbt.data_ptr(),
            out.data_ptr(), s, n, sd, k, stream)
    _raise_on_error(lib, "vdb_pq_decode_recon_t", rc)
    pq_decode_recon_t.launches += 1
    return out


pq_decode_recon_t.launches = 0
