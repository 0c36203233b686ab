"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(the counterpart of ``vector_db_tpu/ops/pallas_kernels.py``).

Each function replaces the TPU kernel of the same name in
``vector_db_tpu/ops/pallas_kernels.py``:

  * six pools on one ``wgmma`` tile loop with a producer warpgroup
    (``vector_db_torch/csrc/pool_wgmma.cuh``): ``fused_int8_pool`` (:585),
    ``fused_packed_pool`` (:900) and ``fused_int8g_pool`` (:726) on its s8
    instance, three entry points in ``vector_db_torch/csrc/fused_int8_pool.cu``
    fed by TMA or cp.async; ``fused_raw_pool`` (:460) and
    ``fused_adc_pool`` (:284) on its bf16 instance, fed by TMA in
    ``vector_db_torch/csrc/fused_raw_pool.cu`` and by the PQ decode in
    ``vector_db_torch/csrc/fused_adc_pool.cu``; ``fused_ivf_pool`` (:1153),
    the cluster-pruned scan of ``scan_ivf``, the s8 loop walking one
    cluster's buckets with the winners picked in registers,
    ``vector_db_torch/csrc/fused_ivf_pool.cu``;
  * ``pq_decode_recon_t`` (:174), ``vector_db_torch/csrc/pq_decode.cu``;
  * ``fused_scan_topk`` (:988), the f32 bucket-winner scan,
    ``vector_db_torch/csrc/fused_scan_topk.cu``.

Each source's header says what bounds it on an H100 and how it is laid out.
The integer and gather kernels are bit-equal to their plain versions; the
two bf16 pools sum exact products in f32 in the tensor cores' order, and
:func:`check_float_pool` holds them to their plain versions within the f32
summation-order bound (:func:`check_scan_topk` does the same for the f32
scan).

Dispatch is on the tensor's device and nothing else: a CPU tensor goes to
the plain version, a CUDA tensor to the kernel, which is built from the
checkout's sources with ``nvcc`` at first use (one compiler per source, in
parallel, into ``build/torch_kernels/`` beside the package, keyed by the
sources' hash) and loaded with ctypes.  A missing ``nvcc``, a failed build
and a failed launch raise; no path sends a CUDA tensor to the plain
version.  The same build (:class:`_Library`) makes the facade's host-side
result builder, ``csrc/results_host.c``, with the host C compiler
(:func:`host_cc`; ``core/types.py``).  Each wrapper counts its kernel
launches in ``<function>.launches``;
while its thread captures a CUDA graph (:func:`captured_launches`) a launch
goes to the capture's tally instead, and each replay of the graph adds the
tally back.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch

LANES = 128
#: the reference kernel's column block; the pool width rounds to a multiple
#: of min(BLOCK_N, max(128, w))
BLOCK_N = 512
#: bytes of [Q, passes * w] scores one chunk of the plain version holds
PLAIN_CHUNK_BYTES = 256 << 20
#: the widest slice of int8 dims whose f32 matmul is exact: every partial
#: sum is an integer below 2^24 (127^2 * 1040 < 2^24)
EXACT_F32_DIMS = 1040
#: the widest int8 row whose int32 cross term cannot overflow (127^2 d < 2^31)
MAX_INT8_DIM = (2**31 - 1) // 127**2

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"


# ------------------------------------------------------------------- build
class _Library:
    """A shared library built from sources under ``csrc/`` once per process
    and source hash.

    ``sources`` globs the files under ``csrc/`` whose bytes key the build,
    headers included (a file whose suffix ends in ``h`` is not compiled);
    ``compiler()`` gives the command that compiles one source (``-c -o obj
    src`` follow) and the one that links the objects (``-o lib objs``
    follow), and raises where the compiler is missing; ``load(path)`` opens
    the built file and declares its entry points.  The file is
    ``lib<name>_<hash>.so`` in ``BUILD_DIR``.

    The first callers of :meth:`get` may be several threads of a server at
    once: a lock makes one of them build and load, the others wait for its
    handle.  Build files carry the pid and the thread id, so processes
    sharing a checkout never write the same object file either."""

    def __init__(self, name: str, sources: str,
                 compiler: Callable[[], tuple[list[str], list[str]]],
                 load: Callable[[Path], ctypes.CDLL]):
        self.name, self.sources = name, sources
        self.compiler, self.load = compiler, load
        self.lib: Optional[ctypes.CDLL] = None
        self.path: Optional[Path] = None
        self.build_log = ""
        self.build_seconds = 0.0
        self._lock = threading.Lock()

    def get(self) -> ctypes.CDLL:
        if self.lib is None:
            with self._lock:
                if self.lib is None:
                    self._load()
        return self.lib

    def _load(self) -> None:
        import time

        hashed = sorted(_CSRC.glob(self.sources))
        sources = [src for src in hashed if not src.suffix.endswith("h")]
        if not sources:
            raise RuntimeError(
                f"no source matches {self.sources!r} under {_CSRC}: the "
                f"package was installed without its csrc/ files")
        digest = hashlib.sha256()
        for src in hashed:
            digest.update(src.read_bytes())
        out = BUILD_DIR / f"lib{self.name}_{digest.hexdigest()[:16]}.so"
        log_path = out.with_suffix(".log")
        if not out.exists():
            compile_cmd, link_cmd = self.compiler()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tag = (f"{digest.hexdigest()[:16]}.{os.getpid()}"
                   f".{threading.get_ident()}")
            objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
            tmp = out.with_suffix(f".{tag}.tmp")
            t0 = time.perf_counter()
            # one compiler per source, all at once, then one link
            procs = [subprocess.Popen(
                [*compile_cmd, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(sources, objs)]
            logs = [p.communicate()[0] for p in procs]
            failed = [(src.name, p.returncode, log) for src, p, log
                      in zip(sources, procs, logs) if p.returncode != 0]
            if not failed:
                link = subprocess.run(
                    [*link_cmd, "-o", str(tmp), *map(str, objs)],
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
                raise RuntimeError(
                    f"{Path(compile_cmd[0]).name} failed:\n" + "\n".join(
                        f"{name} ({rc}):\n{log}" for name, rc, log in failed))
            os.replace(tmp, out)
        self.build_log = log_path.read_text() if log_path.exists() else ""
        self.lib, self.path = self.load(out), out


def _nvcc() -> tuple[list[str], list[str]]:
    """nvcc's compile and link commands for sm_90a."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (CUDA_HOME is unset or has no bin/nvcc); "
            "the CUDA kernels cannot be built")
    flags = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    return [*flags, "-Xptxas", "-v"], [*flags, "-shared"]


def host_cc() -> tuple[list[str], list[str]]:
    """The host C compiler's compile and link commands for a library of
    this interpreter's C API: ``sysconfig``'s ``CC`` where it is on the
    PATH, else ``cc``."""
    cc = shlex.split(sysconfig.get_config_var("CC") or "")
    if not cc or shutil.which(cc[0]) is None:
        cc = ["cc"]
        if shutil.which("cc") is None:
            raise RuntimeError(
                "no host C compiler: neither sysconfig's CC nor cc is on the "
                "PATH; the batched search's result builder "
                "(csrc/results_host.c) needs one (e.g. gcc)")
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(
            f"Python.h not found in {include}: the batched search's result "
            f"builder (csrc/results_host.c) needs this interpreter's "
            f"development headers (e.g. python3-dev)")
    return [*cc, "-O2", "-fPIC", "-I", include], [*cc, "-shared"]


def _load_kernels(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # the pools end (..., w, splits, stages, streamed, stream)
    for pool in (lib.vdb_fused_int8_pool, lib.vdb_fused_packed_pool):
        pool.argtypes = [ptr] * 9 + [i32] * 7 + [ptr]
    lib.vdb_fused_int8g_pool.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
    lib.vdb_fused_raw_pool.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
    lib.vdb_fused_adc_pool.argtypes = ([ptr, ptr, i64] + [ptr] * 6
                                       + [i32] * 9 + [ptr])
    for entry in ("vdb_fused_int8_pool", "vdb_fused_packed_pool",
                  "vdb_fused_int8g_pool", "vdb_fused_raw_pool",
                  "vdb_fused_adc_pool"):
        getattr(lib, entry).restype = i32
    lib.vdb_pq_decode_recon_t.argtypes = ([ptr, i64, ptr, ptr]
                                          + [i32] * 4 + [ptr])
    lib.vdb_fused_ivf_pool.argtypes = [ptr] * 8 + [i32] * 10 + [ptr]
    lib.vdb_fused_scan_topk.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    for entry in ("vdb_pq_decode_recon_t", "vdb_fused_ivf_pool",
                  "vdb_fused_scan_topk"):
        getattr(lib, entry).restype = i32
    lib.vdb_cuda_error_string.argtypes = [i32]
    lib.vdb_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_library() -> _Library:
    """The CUDA kernels' library, not yet built: the ``.cu`` sources (the
    ``.cuh`` headers key it too), built with ``nvcc``."""
    return _Library("vdb_torch_kernels", "*.cu*", _nvcc, _load_kernels)


LIBRARY = kernel_library()


def build_kernels() -> _Library:
    """Build (if needed) and load the kernel library; returns it, with its
    path, the compiler's log and the build time."""
    LIBRARY.get()
    return LIBRARY


# ------------------------------------------------------------- launches
class _Tally(threading.local):
    counts: Optional[dict] = None


_TALLY = _Tally()


def _count_launch(fn) -> None:
    """Count one launch of ``fn``'s kernel in ``fn.launches``, or, while
    this thread captures a CUDA graph, in the capture's tally: a captured
    launch runs only when the graph replays."""
    counts = _TALLY.counts
    if counts is None:
        fn.launches += 1
    else:
        counts[fn] = counts.get(fn, 0) + 1


@contextlib.contextmanager
def captured_launches():
    """Within, this thread's kernel launches are tallied and not counted;
    yields the tally, {wrapper: launches}, which the graph's owner adds to
    the counters at each replay."""
    saved, _TALLY.counts = _TALLY.counts, {}
    try:
        yield _TALLY.counts
    finally:
        _TALLY.counts = saved


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


def _check_s32_range(d: int) -> None:
    if d > MAX_INT8_DIM:
        raise ValueError(f"row width {d} > {MAX_INT8_DIM}: the int32 cross "
                         "term of int8 rows could overflow")


def int8_cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact integer product ``a @ b^T`` of rows of int8 values, a
    [..., M, d] and b [..., N, d] (any dtype holding them), as int32 [...,
    M, N]: f32 matmuls of slices of at most :data:`EXACT_F32_DIMS` dims,
    each exact with TF32 off, summed in int32.  At d <= 1040 that is one
    f32 matmul, as the plain versions always were."""
    out = None
    for k0 in range(0, max(1, a.shape[-1]), EXACT_F32_DIMS):
        part = (a[..., k0:k0 + EXACT_F32_DIMS].to(torch.float32)
                @ b[..., k0:k0 + EXACT_F32_DIMS].to(torch.float32)
                .transpose(-1, -2)).to(torch.int32)
        out = part if out is None else out + part
    return out


def _check_pool_args(q, base8, sel_off, sel_scale):
    n, d = base8.shape
    if q.ndim != 2 or q.shape[1] > d:
        raise ValueError(f"queries {tuple(q.shape)} wider than shadow {d}")
    if base8.dtype != torch.int8:
        raise TypeError(f"base8 must be int8, got {base8.dtype}")
    if sel_off.shape != (n,) or sel_scale.shape != (n,):
        raise ValueError("sel_off/sel_scale must be [N] like base8's rows")
    _check_s32_range(d)


def _pool_plain(score, n: int, qn: int, w: int, device, fill):
    """The strided min pool of the plain versions: vals[q, c] = min over
    passes j of the score of slot c + j*w (strict <: the earliest pass keeps
    a tie), slots[q, c] its slot, starting from (``fill``, -1).
    ``score(r0, r1)`` gives the [Q, r1 - r0] scores of slots r0..r1 (f32, or
    int32 when ``fill`` is an int); slots past N score ``fill`` and never
    win.  Passes go in chunks of at most ``PLAIN_CHUNK_BYTES`` of [Q,
    passes * w] scores, so the [Q, N] scores never exist whole."""
    dtype = torch.int32 if isinstance(fill, int) else torch.float32
    vals = torch.full((qn, w), fill, dtype=dtype, device=device)
    slots = torch.full((qn, w), -1, dtype=torch.int32, device=device)
    passes = -(-n // w)
    per_chunk = max(1, PLAIN_CHUNK_BYTES // max(1, 4 * qn * w))
    cols = torch.arange(w, dtype=torch.int32, device=device)
    for p0 in range(0, passes, per_chunk):
        p1 = min(passes, p0 + per_chunk)
        r0, r1 = p0 * w, min(n, p1 * w)
        s = score(r0, r1)
        if r1 - r0 < (p1 - p0) * w:  # ragged last pass
            s = torch.nn.functional.pad(s, (0, (p1 - p0) * w - (r1 - r0)),
                                        value=fill)
        s = s.view(qn, p1 - p0, w)
        for j in range(p1 - p0):
            better = s[:, j] < vals
            vals = torch.where(better, s[:, j], vals)
            slots = torch.where(better, cols + (p0 + j) * w, slots)
    return vals, slots


def _mask_empty(vals: torch.Tensor, slots: torch.Tensor):
    """An f32 pool's empty entries (+inf) get slot -1."""
    return vals, torch.where(torch.isfinite(vals), slots,
                             torch.full_like(slots, -1))


def fused_int8_pool_plain(q: torch.Tensor, base8: torch.Tensor,
                          sel_off: torch.Tensor, sel_scale: torch.Tensor,
                          w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_int8_pool`, on any device.

    The cross term is exact at any width (:func:`int8_cross`) and turns
    to f32 once, as the reference's ``cross.astype(jnp.float32)`` does.
    """
    _check_pool_args(q, base8, sel_off, sel_scale)
    n, d = base8.shape
    q8, sq = _quantize_rows_int8(q.to(torch.float32))
    qf = _pad_cols(q8, d).to(torch.float32)

    def score(r0, r1):
        cross = int8_cross(qf, base8[r0:r1]).to(torch.float32)
        return sel_off[None, r0:r1] + (cross * sel_scale[None, r0:r1]) * sq[:, None]
    return _mask_empty(*_pool_plain(score, n, q.shape[0], pool_width(w),
                                    q.device, float("inf")))


def fused_int8_pool(q: torch.Tensor, base8: torch.Tensor,
                    sel_off: torch.Tensor, sel_scale: torch.Tensor,
                    w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused s8 x s8 scan + strided-bucket min pool over an int8 shadow.

    q [Q, d] f32, pre-centered by the caller, quantized here per row to
    int8; base8 [N, d8] int8 (d8 >= d, d8 % 4 == 0 on CUDA, any width
    below the int32 range; the extra columns are the shadow's zero
    padding); sel_off [N] f32 (+inf at dead slots); sel_scale [N] f32.
    The score of slot n is
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
    out = _launch_scaled_pool("vdb_fused_int8_pool", q, base8, sel_off,
                              sel_scale, pool_width(w), base8.shape[1])
    _count_launch(fused_int8_pool)
    return out


fused_int8_pool.launches = 0


def _check_same_device(q, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, queries on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


#: query rows per block of the pools on the wgmma tile loop
#: (``csrc/pool_wgmma.cuh``: two consumer warpgroups x m64)
POOL_TILE_Q = 128
#: the shared memory of one block of that loop on an H100 (232,448 bytes),
#: in k-chunks of [128 rows x 128 bytes] (64 bf16 or 128 int8 dims): the
#: query tile (resident) or one query slab a stage (streamed), the ring
#: stages, and a fixed part: 2 KB of per-column values, 256 B of barriers
#: and 1 KB to align the tiles
_WG_SMEM = 232448
_WG_CHUNK = 128 * 128
_WG_FIXED = 1024 + 2048 + 256
#: the fewest ring stages the loop's hand-overs need (it has barriers for
#: the 12 that fit beside the narrowest query tile)
_WG_MIN_STAGES = 3
#: the ring depth of the bf16 pools and of the s8 pools (the stage sweep
#: of chip_smoke.py phase 3, on an H100)
BF16_POOL_STAGES = 4
S8_POOL_STAGES = 9


def wgmma_plan(row_bytes: int, max_stages: int) -> tuple[int, bool]:
    """(stages, streamed) of the wgmma tile loop for rows of ``row_bytes``
    bytes, the arithmetic of ``csrc/pool_wgmma.cuh``: the query tile stays
    resident (ceil(row_bytes / 128) chunks) while it and at least three
    stages fit, with up to ``max_stages`` stages; past that each 32 KB
    stage streams its query slab beside its corpus slab, so any width
    fits."""
    kc_n = -(-row_bytes // 128)
    room = (_WG_SMEM - _WG_FIXED) // _WG_CHUNK
    if room - kc_n >= _WG_MIN_STAGES:
        return min(max_stages, room - kc_n), False
    return min(max_stages, room // 2), True


def pool_splits(qn: int, n: int, w: int, sms: int) -> int:
    """How many blocks share the passes of one (128-query, 128-column)
    tile, each taking at least one pass.  The pools (one block an SM) take
    one wave when their tiles fill >= 90% of the SMs or there is one query
    tile (its blocks are alike), else ~2 waves, which evens out tiles whose
    query rows lie partly past Q (the pass-split sweeps of chip_smoke.py
    phases 3, 3e and 3f, on an H100)."""
    passes = -(-n // w) if n else 0
    tiles = (w // LANES) * -(-qn // POOL_TILE_Q)
    if 10 * tiles >= 9 * sms:
        want = 1
    elif qn <= POOL_TILE_Q:
        want = sms // tiles
    else:
        want = 2 * sms // tiles
    want = max(1, min(passes, want))
    # as many splits as ceil(passes / want) passes each fill: none is empty
    return -(-passes // -(-passes // want)) if passes else 1


def _run_pool(entry: str, head, mid, qn: int, n: int, w: int, device,
              row_bytes: int, max_stages: int, val_dtype=torch.float32):
    """Launch a pool kernel through C entry ``entry`` as
    ``entry(*head, part_vals, part_slots, vals, slots, qn, n, *mid, w,
    splits, stages, streamed, stream)`` and return (vals, slots) [qn, w].
    The ring and the query tile's layout follow :func:`wgmma_plan` for rows
    of ``row_bytes``; the passes are split over blocks when the query x
    column tiles alone leave the card's SMs idle (:func:`pool_splits`; the
    partial pools merge in pass order); raises if the launch fails."""
    lib = LIBRARY.get()
    vals = torch.empty((qn, w), dtype=val_dtype, device=device)
    slots = torch.empty((qn, w), dtype=torch.int32, device=device)
    if qn == 0:
        return vals, slots
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = pool_splits(qn, n, w, sms)
    stages, streamed = wgmma_plan(row_bytes, max_stages)
    if splits > 1:
        part_v = torch.empty((splits, qn, w), dtype=val_dtype, device=device)
        part_s = torch.empty((splits, qn, w), dtype=torch.int32,
                             device=device)
    else:
        part_v, part_s = vals, slots
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(
            *head, part_v.data_ptr(), part_s.data_ptr(), vals.data_ptr(),
            slots.data_ptr(), qn, n, *mid, w, splits, stages, int(streamed),
            stream)
    _raise_on_error(lib, entry, rc)
    return vals, slots


def _launch_scaled_pool(entry: str, q, base, sel_off, sel_scale, w: int,
                        d: int):
    """B2/B4 through C entry ``entry`` over ``base``'s rows (int8 [N, d] or
    int32 words [N, d/4]): quantize the queries and pad them to rows of
    whole 16-byte vectors (TMA), then launch."""
    _check_same_device(q, base=base, sel_off=sel_off, sel_scale=sel_scale)
    if sel_off.dtype != torch.float32 or sel_scale.dtype != torch.float32:
        raise TypeError("sel_off/sel_scale must be float32")
    q8, sq = _quantize_rows_int8(q.to(torch.float32))
    q8 = _pad_cols(q8, d + (-d) % 16).contiguous()
    sq = sq.contiguous()
    return _run_pool(entry, (q8.data_ptr(), sq.data_ptr(), base.data_ptr(),
                             sel_off.data_ptr(), sel_scale.data_ptr()),
                     (d,), q.shape[0], base.shape[0], w, q.device, d,
                     S8_POOL_STAGES)


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
    _check_s32_range(4 * dw)
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
    out = _launch_scaled_pool("vdb_fused_packed_pool", q, packed, sel_off,
                              sel_scale, w, 4 * packed.shape[1])
    _count_launch(fused_packed_pool)
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
    _count_launch(pq_decode_recon_t)
    return out


pq_decode_recon_t.launches = 0


# ------------------------------------------------------- fused_int8g_pool
#: a pool score at or above this is a dead or empty slot (the reference's
#: ``_I32_REAL_MAX``): real scores are bounded by the off_i clip (2^26) plus
#: max |cross| (127^2 d, below 2^26 up to 4,160 dims); dead slots carry 2^29
I32_REAL_MAX = 1 << 28
_OFF_I_CLIP = float(1 << 26)
_OFF_I_DEAD = float(1 << 29)
_I32_INIT = 2**31 - 1


def _int8g_condition(q, sel_off, sv, sgn: float, d: int):
    """The per-batch integer conditioning of :func:`fused_int8g_pool`, in the
    reference's order (``pallas_kernels.py:777-785``): one scale over the
    whole batch sq = max(max|q|, 1e-12) / 127, q8 = round(q / sq), the
    batch constant C = sgn * sv * sq and off_i = clip(round(off / C),
    +-2^26) with 2^29 at dead slots.  Returns (q8 padded to d columns,
    off_i int32, C)."""
    q = q.to(torch.float32)
    sq = torch.clamp(torch.amax(torch.abs(q)), min=1e-12) / 127.0
    q8 = torch.clamp(torch.round(q / sq), -127, 127).to(torch.int8)
    c = sgn * sv * sq
    off_i = torch.where(
        torch.isfinite(sel_off),
        torch.clamp(torch.round(sel_off / c), -_OFF_I_CLIP, _OFF_I_CLIP),
        _OFF_I_DEAD).to(torch.int32)
    return _pad_cols(q8, d), off_i, c


def _int8g_finish(vals_i, slots, c, n: int):
    """The integer pool back to f32: vals_i * C where the score is real
    (< 2^28, a slot below N), else +inf and slot -1 (``:826-828``)."""
    real = (vals_i < I32_REAL_MAX) & (slots >= 0) & (slots < n)
    vals = torch.where(real, vals_i.to(torch.float32) * c, float("inf"))
    return vals, torch.where(real, slots, torch.full_like(slots, -1))


def _check_int8g_args(q, base8, sel_off):
    n, d = base8.shape
    if q.ndim != 2 or q.shape[1] > d:
        raise ValueError(f"queries {tuple(q.shape)} wider than shadow {d}")
    if base8.dtype != torch.int8:
        raise TypeError(f"base8 must be int8, got {base8.dtype}")
    if sel_off.shape != (n,):
        raise ValueError("sel_off must be [N] like base8's rows")
    _check_s32_range(d)


def fused_int8g_pool_plain(q: torch.Tensor, base8: torch.Tensor,
                           sel_off: torch.Tensor, sv: torch.Tensor,
                           sgn: float, w: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_int8g_pool`, on any device: the
    cross term is exact at any width (:func:`int8_cross`), the scores
    ``off_i - cross`` and the pool int32."""
    _check_int8g_args(q, base8, sel_off)
    n, d = base8.shape
    q8, off_i, c = _int8g_condition(q, sel_off, sv, sgn, d)
    qf = q8.to(torch.float32)

    def score(r0, r1):
        return off_i[None, r0:r1] - int8_cross(qf, base8[r0:r1])
    vals_i, slots = _pool_plain(score, n, q.shape[0], pool_width(w),
                                q.device, _I32_INIT)
    return _int8g_finish(vals_i, slots, c, n)


def fused_int8g_pool(q: torch.Tensor, base8: torch.Tensor,
                     sel_off: torch.Tensor, sv: torch.Tensor, sgn: float,
                     w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused s8 x s8 scan + strided-bucket min pool with an all-integer
    epilogue, over a global-scale int8 shadow.

    q [Q, d] f32, pre-centered by the caller, quantized here with ONE scale
    over the whole batch (the padded rows included, as in the reference);
    base8 [N, d8] int8 = round(centered row / sv), one scale ``sv`` (a 0-d
    f32 tensor) for the corpus; sel_off [N] f32 (+inf at dead slots);
    ``sgn`` > 0 the metric factor (2 under L2, 1 under cosine).  The score
    of slot n is C * (off_i[n] - q8 . v8_n) with C = sgn * sv * sq (see
    :func:`_int8g_condition`); the pool is ranked in int32 and scaled back
    by C.  Returns an unranked pool like :func:`fused_int8_pool`: vals
    [Q, W] f32 (+inf where empty) and slots [Q, W] int32 (-1).

    A CPU tensor runs :func:`fused_int8g_pool_plain`; a CUDA tensor runs
    the kernel (``csrc/fused_int8_pool.cu``, entry ``vdb_fused_int8g_pool``,
    bit-equal to the plain version) and counts one launch in
    ``fused_int8g_pool.launches``.
    """
    if q.device.type == "cpu":
        return fused_int8g_pool_plain(q, base8, sel_off, sv, sgn, w)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_int8g_args(q, base8, sel_off)
    n, d = base8.shape
    if d % 4 != 0 or base8.data_ptr() % 4 != 0:
        raise ValueError("base8 rows must be whole 4-byte words (d % 4 == 0)")
    _check_same_device(q, base8=base8, sel_off=sel_off)
    q8, off_i, c = _int8g_condition(q, sel_off, sv, sgn, d)
    q8 = _pad_cols(q8, d + (-d) % 16).contiguous()  # whole 16-byte rows
    w = pool_width(w)
    vals_i, slots = _run_pool(
        "vdb_fused_int8g_pool",
        (q8.data_ptr(), base8.data_ptr(), off_i.data_ptr()), (d,),
        q.shape[0], n, w, q.device, d, S8_POOL_STAGES,
        val_dtype=torch.int32)
    _count_launch(fused_int8g_pool)
    return _int8g_finish(vals_i, slots, c, n)


fused_int8g_pool.launches = 0


# ---------------------------------------------------------- fused_raw_pool
def _check_raw_args(q, base16, sel_off, sel_scale):
    n, d = base16.shape
    if q.ndim != 2 or q.shape[1] > d:
        raise ValueError(f"queries {tuple(q.shape)} wider than shadow {d}")
    if base16.dtype != torch.bfloat16:
        raise TypeError(f"base16 must be bfloat16, got {base16.dtype}")
    if sel_off.shape != (n,) or sel_scale.shape != (n,):
        raise ValueError("sel_off/sel_scale must be [N] like base16's rows")


def fused_raw_pool_plain(q: torch.Tensor, base16: torch.Tensor,
                         sel_off: torch.Tensor, sel_scale: torch.Tensor,
                         w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_raw_pool`, on any device: the
    f32 matmul of the bf16 values (each product exact in f32, the sums in
    f32), then ``off + cross * sc`` and the pool."""
    _check_raw_args(q, base16, sel_off, sel_scale)
    n, d = base16.shape
    qf = _pad_cols(q.to(torch.bfloat16), d).to(torch.float32)

    def score(r0, r1):
        cross = qf @ base16[r0:r1].to(torch.float32).T
        return sel_off[None, r0:r1] + cross * sel_scale[None, r0:r1]
    return _mask_empty(*_pool_plain(score, n, q.shape[0], pool_width(w),
                                    q.device, float("inf")))


def fused_raw_pool(q: torch.Tensor, base16: torch.Tensor,
                   sel_off: torch.Tensor, sel_scale: torch.Tensor,
                   w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused bf16 scan + strided-bucket min pool over a bf16 corpus shadow.

    q [Q, d] f32, pre-centered by the caller, rounded here to bf16 (nearest
    even); base16 [N, d16] bf16 (d16 >= d, the extra columns the shadow's
    zero padding); sel_off [N] f32 (+inf at dead slots); sel_scale [N] f32.
    The score of slot n is ``off[n] + (q16 . v16_n) * sel_scale[n]``, the
    products summed in f32.  Returns the unranked pool like
    :func:`fused_int8_pool`.

    A CPU tensor runs :func:`fused_raw_pool_plain`; a CUDA tensor runs the
    kernel (``csrc/fused_raw_pool.cu`` on ``csrc/pool_wgmma.cuh``; the f32
    sums run in the tensor cores' order, so it agrees with the plain
    version within the summation-order bound of :func:`raw_pool_terms`)
    and counts one launch in ``fused_raw_pool.launches``.
    """
    if q.device.type == "cpu":
        return fused_raw_pool_plain(q, base16, sel_off, sel_scale, w)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_raw_args(q, base16, sel_off, sel_scale)
    n, d = base16.shape
    _check_same_device(q, base16=base16, sel_off=sel_off,
                       sel_scale=sel_scale)
    if sel_off.dtype != torch.float32 or sel_scale.dtype != torch.float32:
        raise TypeError("sel_off/sel_scale must be float32")
    d8 = d + (-d) % 8
    if d8 != d or base16.data_ptr() % 16:
        # TMA reads rows of whole, aligned 16-byte vectors: a copy, for
        # callers other than the index (its shadows are padded to 8 dims)
        padded = torch.zeros((n, d8), dtype=torch.bfloat16, device=q.device)
        padded[:, :d] = base16
        base16 = padded
    q16 = _pad_cols(q.to(torch.bfloat16), d8).contiguous()
    out = _run_pool("vdb_fused_raw_pool",
                    (q16.data_ptr(), base16.data_ptr(), sel_off.data_ptr(),
                     sel_scale.data_ptr()), (d8,), q.shape[0], n,
                    pool_width(w), q.device, 2 * d8, BF16_POOL_STAGES)
    _count_launch(fused_raw_pool)
    return out


fused_raw_pool.launches = 0


# ---------------------------------------------------------- fused_adc_pool
def _check_adc_args(q, codes_t, cbt, masked_norms):
    s, n, sd, k = _check_decode_args(codes_t, cbt)
    if q.ndim != 2 or q.shape[1] != s * sd:
        raise ValueError(f"queries {tuple(q.shape)} do not match the "
                         f"codebooks' {s * sd} dims")
    if masked_norms.shape != (n,):
        raise ValueError("masked_norms must be [N] like the code columns")
    return s, n, sd, k


def fused_adc_pool_plain(q: torch.Tensor, codes_t: torch.Tensor,
                         cbt: torch.Tensor, masked_norms: torch.Tensor,
                         w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_adc_pool`, on any device: the
    plain decode (:func:`pq_decode_recon_t_plain`) of a pass chunk, the f32
    product of the bf16 values, ``norms - 2 * cross`` and the pool."""
    _check_adc_args(q, codes_t, cbt, masked_norms)
    n = codes_t.shape[1]
    qf = q.to(torch.bfloat16).to(torch.float32)

    def score(r0, r1):
        recon = pq_decode_recon_t_plain(codes_t[:, r0:r1], cbt)
        cross = qf @ recon.to(torch.float32)
        return masked_norms[None, r0:r1] - 2.0 * cross
    return _mask_empty(*_pool_plain(score, n, q.shape[0], pool_width(w),
                                    q.device, float("inf")))


def fused_adc_pool(q: torch.Tensor, codes_t: torch.Tensor, cbt: torch.Tensor,
                   masked_norms: torch.Tensor, w: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused PQ decode + bf16 scan + strided-bucket min pool, one kernel.

    q [Q, d] (any float; rounded here to bf16 on every device, as the
    reference does, ``pallas_kernels.py:332``) in PQ space; codes_t [S, N]
    integer codes (on CUDA uint8 with unit column stride: a column slice
    of a wider code matrix is read in place); cbt [S*sd, K <= 256] f32 in
    the decode kernel's layout; masked_norms [N] f32 squared reconstruction
    norms (+inf at dead slots).  The score of slot n is ``norms[n] - 2 *
    (q16 . recon_n)``, recon_n the bf16 decode of column n; neither the
    [d, N] reconstruction nor the [Q, N] scores is written.  Returns the
    unranked pool like :func:`fused_int8_pool` (W = :func:`pool_width` (w);
    N need not be a multiple of W).

    A CPU tensor runs :func:`fused_adc_pool_plain`; a CUDA tensor runs the
    kernel (``csrc/fused_adc_pool.cu``; it agrees with the plain version
    within the summation-order bound of :func:`adc_pool_terms`) and counts
    one launch in ``fused_adc_pool.launches``.
    """
    if q.device.type == "cpu":
        return fused_adc_pool_plain(q, codes_t, cbt, masked_norms, w)
    if codes_t.device.type != "cuda" or q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    s, n, sd, k = _check_adc_args(q, codes_t, cbt, masked_norms)
    if codes_t.dtype != torch.uint8 or codes_t.stride(1) != 1:
        raise ValueError("codes_t must be uint8 with unit column stride")
    _check_same_device(q, cbt=cbt, masked_norms=masked_norms)
    if codes_t.device != q.device:
        raise ValueError(f"codes_t on {codes_t.device}, queries on {q.device}")
    if cbt.dtype != torch.float32 or masked_norms.dtype != torch.float32:
        raise TypeError("cbt/masked_norms must be float32")
    # the queries in rows of whole 16-byte vectors (TMA), zeros past S*sd
    d8 = s * sd + (-s * sd) % 8
    q16 = _pad_cols(q.to(torch.bfloat16), d8).contiguous()
    # the [S, K, sd] bf16 table: one codebook entry is sd consecutive values
    cbk = cbt.view(s, sd, k).permute(0, 2, 1).to(torch.bfloat16).contiguous()
    out = _run_pool("vdb_fused_adc_pool",
                    (q16.data_ptr(), codes_t.data_ptr(),
                     max(codes_t.stride(0), n), cbk.data_ptr(),
                     masked_norms.data_ptr()), (s, sd, k), q.shape[0], n,
                    pool_width(w), q.device, 2 * d8, BF16_POOL_STAGES)
    _count_launch(fused_adc_pool)
    return out


fused_adc_pool.launches = 0


# ------------------------------------------- holding a bf16 pool to its plain
def _gathered_terms(q16f, rows_of, slots, chunk_q: int = 64):
    """(cross, |q|.|v|) [Q, W] of each query with the row of its pool slot:
    ``rows_of(idx)`` gives the f32 rows [m, d] of slots idx [m]."""
    qn, w = slots.shape
    cross = torch.empty((qn, w), device=slots.device)
    absp = torch.empty((qn, w), device=slots.device)
    for q0 in range(0, qn, chunk_q):
        s = slots[q0:q0 + chunk_q].clamp(min=0).long()
        v = rows_of(s.reshape(-1)).reshape(*s.shape, -1)      # [c, W, d]
        qq = q16f[q0:q0 + chunk_q, :, None]
        cross[q0:q0 + chunk_q] = torch.bmm(v, qq)[:, :, 0]
        absp[q0:q0 + chunk_q] = torch.bmm(v.abs(), qq.abs())[:, :, 0]
    return cross, absp


def _summation_bound(d: int, absp, sc_abs, score):
    """The f32 summation-order bound 2 d 2^-24 (|q|.|v|) |sc| (two sums of
    the same exact products in different orders differ by at most this),
    plus one ulp of the score for the epilogue's two roundings of values
    that already differ."""
    return 2.0 * d * 2.0 ** -24 * absp * sc_abs + 2.0 ** -23 * score.abs()


def raw_pool_terms(q, base16, sel_off, sel_scale, slots):
    """For a [Q, W] slot matrix of :func:`fused_raw_pool`: the plain score
    of each query with its slot and the summation-order bound of that
    score (:func:`check_float_pool`)."""
    d = base16.shape[1]
    q16f = _pad_cols(q.to(torch.bfloat16), d).to(torch.float32)
    cross, absp = _gathered_terms(
        q16f, lambda i: base16[i].to(torch.float32), slots)
    s = slots.clamp(min=0).long()
    score = sel_off[s] + cross * sel_scale[s]
    return score, _summation_bound(d, absp, sel_scale[s].abs(), score)


def adc_pool_terms(q, codes_t, cbt, masked_norms, slots):
    """:func:`raw_pool_terms` for :func:`fused_adc_pool`: the rows are the
    bf16 decodes of the slots' code columns, ``|sc|`` = 2."""
    d = cbt.shape[0]
    q16f = q.to(torch.bfloat16).to(torch.float32)
    cross, absp = _gathered_terms(
        q16f, lambda i: pq_decode_recon_t_plain(
            codes_t[:, i], cbt).to(torch.float32).T, slots)
    score = masked_norms[slots.clamp(min=0).long()] - 2.0 * cross
    return score, _summation_bound(d, absp, 2.0, score)


def check_float_pool(kernel, plain, terms, w: int) -> dict:
    """Hold a bf16 pool kernel's (vals, slots) to its plain version's where
    bit-equality cannot hold (the f32 sums run in another order):

      * the empty entries (+inf, slot -1) are the same;
      * the slots agree in >= 99.9% of the entries;
      * where they agree, |kernel - plain| <= the bound at that slot;
      * where they differ, the kernel's slot lies in the entry's bucket,
        the kernel's value is within the bound of the plain score of its
        slot, and that score is within the two slots' bounds of the plain
        minimum (the kernel's pick can beat the plain one only by both
        rounding errors).

    ``terms(slots)`` returns (plain score, bound) [Q, W] for a slot matrix
    (:func:`raw_pool_terms`, :func:`adc_pool_terms`).  Returns the
    agreement share, the largest |difference| and ``ok``."""
    kv, ks = kernel
    pv, ps = plain
    empty_k, empty_p = ks < 0, ps < 0
    same_empty = bool(torch.equal(empty_k, empty_p)
                      and torch.isinf(kv[empty_k]).all()
                      and torch.isfinite(kv[~empty_k]).all())
    live = ~empty_p
    agree = (ks == ps) & live
    share = float(agree.sum()) / max(1, int(live.sum()))
    k_score, k_bound = terms(ks)
    _, p_bound = terms(ps)
    diff = (kv - pv).abs()
    ok_agree = bool((diff[agree] <= p_bound[agree]).all())
    dis = live & ~agree
    col = torch.arange(ks.shape[1], device=ks.device)[None, :].expand_as(ks)
    ok_dis = bool(((ks[dis] % w) == col[dis]).all()
                  and ((kv[dis] - k_score[dis]).abs() <= k_bound[dis]).all()
                  and ((k_score[dis] - pv[dis]).abs()
                       <= k_bound[dis] + p_bound[dis]).all())
    err = float(diff[live].max()) if live.any() else 0.0
    return {"slot_agreement": share, "max_abs_err": err,
            "ok": same_empty and share >= 0.999 and ok_agree and ok_dis}


# ---------------------------------------------------------- fused_ivf_pool
#: the width of one (cluster, prober) pool row (the reference's ``IVF_PW``)
IVF_PW = 128
#: bytes of [clusters, p_cap, cap] f32 scores one step of the plain version
#: holds
IVF_PLAIN_CHUNK_BYTES = 256 << 20
#: the ring depth of the cluster scan (the stage sweep of chip_smoke.py
#: phase 3g, on an H100)
IVF_POOL_STAGES = 9


class IvfPoolPlan(NamedTuple):
    """The launch of ``csrc/fused_ivf_pool.cu`` (:func:`ivf_pool_plan`)."""
    tile_rows: int          #: prober rows of one block's resident tile
    tiles: int              #: blocks along x: >= the live (cluster, tile)s
    splits: int             #: blocks along y sharing one cluster's buckets
    buckets_per_split: int  #: split y takes buckets [y * this, (y + 1) * this)
    stages: int             #: ring stages
    streamed: bool          #: the prober tile streams beside each stage


def ivf_pool_plan(nlist: int, cap: int, p_cap: int, row_bytes: int, sms: int,
                  probes: Optional[int] = None) -> IvfPoolPlan:
    """How the cluster scan is laid over the card, the arithmetic of
    ``csrc/fused_ivf_pool.cu``: one block owns a (cluster, 128-prober tile)
    pair and walks the cluster's cap / 128 buckets.  ``tiles`` bounds the
    live pairs: every pair, or with ``probes`` (an upper bound of the
    batch's (query, probe) pairs) at most one a probed cluster and one more
    for every 128 probes.  When the pairs leave more than half of the
    ``sms`` SMs idle (one query probes 64 clusters), ``splits`` blocks share
    each cluster's buckets, ceil(buckets / splits) each and none empty, as
    many as still run in one wave (a second wave cost more than it gave:
    the bucket-split sweep of chip_smoke.py phase 3g, on an H100); buckets
    write disjoint columns, so nothing is merged.  The ring and the prober
    tile's layout follow :func:`wgmma_plan` for rows of ``row_bytes``."""
    ptiles = -(-p_cap // POOL_TILE_Q)
    tiles = nlist * ptiles
    if probes is not None:
        tiles = max(1, min(tiles, min(nlist, probes) + probes // POOL_TILE_Q))
    buckets = cap // LANES
    want = max(1, min(buckets, sms // tiles))
    per = -(-buckets // want)
    stages, streamed = wgmma_plan(row_bytes, IVF_POOL_STAGES)
    return IvfPoolPlan(POOL_TILE_Q, tiles, -(-buckets // per), per, stages,
                       streamed)


def _check_ivf_args(counts, qsel, cm, sel_off, sel_scale, nlist: int,
                    cap: int, p_cap: int, winners: int) -> int:
    """Validate a cluster-pruned pool call; returns the words per row."""
    dw = cm.shape[1]
    if qsel.dtype != torch.int32 or cm.dtype != torch.int32:
        raise TypeError("qsel and cm must be int32 words of four int8 dims")
    if tuple(qsel.shape) != (nlist * p_cap, dw):
        raise ValueError(f"qsel {tuple(qsel.shape)} is not [nlist * p_cap = "
                         f"{nlist * p_cap}, {dw}]")
    if cm.shape[0] != nlist * cap:
        raise ValueError(f"cm has {cm.shape[0]} rows, not nlist * cap = "
                         f"{nlist * cap}")
    if not cm.is_contiguous():
        raise ValueError("cm must be contiguous")
    if sel_off.shape != (nlist * cap,) or sel_scale.shape != (nlist * cap,):
        raise ValueError("sel_off/sel_scale must be [nlist * cap]")
    if counts.shape != (nlist,):
        raise ValueError("counts must be [nlist]")
    if cap % LANES or winners < 1 or winners * (cap // LANES) > IVF_PW:
        raise ValueError(f"cap={cap} must be a multiple of {LANES} with "
                         f"winners * cap / {LANES} <= {IVF_PW}")
    _check_s32_range(4 * dw)
    return dw


def fused_ivf_pool_plain(counts: torch.Tensor, qsel: torch.Tensor,
                         cm: torch.Tensor, sel_off: torch.Tensor,
                         sel_scale: torch.Tensor, nlist: int, cap: int,
                         p_cap: int, winners: int = 4
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_ivf_pool`, on any device: for
    each probed cluster (a host list of the clusters with counts > 0) the
    exact product of the unpacked int8 rows (:func:`int8_cross`) turned to
    f32 once, ``off + cross * sc``, and the winners by repeated ``argmin``
    (first index on ties) with the winner masked to +inf.  Every row of a
    probed cluster is written, those past its count too."""
    dw = _check_ivf_args(counts, qsel, cm, sel_off, sel_scale, nlist, cap,
                         p_cap, winners)
    dev = cm.device
    bpb = cap // LANES
    used = winners * bpb
    vals = torch.empty((nlist * p_cap, IVF_PW), dtype=torch.float32,
                       device=dev)
    pos = torch.empty((nlist * p_cap, IVF_PW), dtype=torch.int32, device=dev)
    probed = torch.nonzero(counts > 0).flatten()
    per = max(1, IVF_PLAIN_CHUNK_BYTES // (4 * p_cap * cap))
    lane_base = torch.arange(bpb, device=dev) * LANES
    rank = torch.arange(p_cap, device=dev)
    for s in range(0, probed.numel(), per):
        cid = probed[s:s + per]
        b = cid.numel()
        q = unpack_words_int8(qsel.view(nlist, p_cap, dw)[cid].reshape(
            -1, dw)).view(b, p_cap, 4 * dw)
        v = unpack_words_int8(cm.view(nlist, cap, dw)[cid].reshape(
            -1, dw)).view(b, cap, 4 * dw)
        cross = int8_cross(q, v).to(torch.float32)              # [b, P, cap]
        cur = (sel_off.view(nlist, cap)[cid][:, None, :]
               + cross * sel_scale.view(nlist, cap)[cid][:, None, :])
        cur = cur.view(b, p_cap, bpb, LANES)
        first = (cid * cap)[:, None, None] + lane_base[None, None, :]
        cols_v, cols_p = [], []
        for t in range(winners):
            a = torch.argmin(cur, dim=3, keepdim=True)          # [b, P, bpb, 1]
            cols_v.append(torch.gather(cur, 3, a)[..., 0])
            cols_p.append(first + a[..., 0])
            if t + 1 < winners:
                cur = cur.scatter(3, a, float("inf"))
        rows = (cid[:, None] * p_cap + rank[None, :]).reshape(-1)
        vals[rows, :used] = torch.cat(cols_v, dim=2).reshape(-1, used)
        pos[rows, :used] = torch.cat(cols_p, dim=2).reshape(-1, used).to(
            torch.int32)
        vals[rows, used:] = float("inf")
        pos[rows, used:] = -1
    return vals, pos


def fused_ivf_pool(counts: torch.Tensor, qsel: torch.Tensor, cm: torch.Tensor,
                   sel_off: torch.Tensor, sel_scale: torch.Tensor, nlist: int,
                   cap: int, p_cap: int, winners: int = 4,
                   probes: Optional[int] = None,
                   out: Optional[tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cluster-pruned s8 scan + per-bucket winners (``search_mode=
    "scan_ivf"``).

    counts [nlist] int32: the prober rows of each cluster's tile (0 = the
    cluster is not probed; the port's device-built stand-in for the
    reference's sorted worklist); qsel [nlist * p_cap, d/4] int32 words of
    the prober queries' int8 rows (one global batch scale, pre-folded into
    ``sel_scale``); cm [nlist * cap, d/4] int32 the cluster-major corpus
    rows; sel_off / sel_scale [nlist * cap] f32 per grid position (+inf off
    at pads and disabled rows).  For prober row p of cluster c and grid
    position c*cap + j the score is ``off + f32(q8 . v8) * sc``; each
    128-column bucket b keeps its ``winners`` best, winner t in column
    t * cap/128 + b with position c*cap + b*128 + lane; columns past
    winners * cap/128 hold (+inf, -1).  Returns (vals [nlist * p_cap, 128]
    f32, pos [nlist * p_cap, 128] int32).  Rows of unprobed clusters and
    rows at or past a cluster's count are undefined: callers read only the
    rows of their (query, probe) pairs.

    ``probes``, where the caller knows it, is an upper bound of
    ``counts.sum()`` (a batch's queries x nprobe): it only sizes the
    kernel's grid (:func:`ivf_pool_plan`), and a bound below the truth
    leaves clusters unscanned.  ``out``, where given, is the (vals, pos)
    pair the kernel writes into (contiguous, of the returned shapes and
    types, on ``cm``'s device); rows that are undefined keep what they held.

    A CPU tensor runs :func:`fused_ivf_pool_plain`; a CUDA tensor runs the
    kernel (``csrc/fused_ivf_pool.cu``, bit-equal to the plain version on
    the rows that are read) and counts one launch in
    ``fused_ivf_pool.launches``.
    """
    if cm.device.type == "cpu":
        res = fused_ivf_pool_plain(counts, qsel, cm, sel_off, sel_scale,
                                   nlist, cap, p_cap, winners)
        if out is not None:
            out[0].copy_(res[0])
            out[1].copy_(res[1])
        return res if out is None else out
    if cm.device.type != "cuda":
        raise ValueError(f"unsupported device {cm.device}")
    dw = _check_ivf_args(counts, qsel, cm, sel_off, sel_scale, nlist, cap,
                         p_cap, winners)
    _check_same_device(cm, counts=counts, qsel=qsel, sel_off=sel_off,
                       sel_scale=sel_scale)
    if counts.dtype != torch.int32:
        raise TypeError("counts must be int32")
    if sel_off.dtype != torch.float32 or sel_scale.dtype != torch.float32:
        raise TypeError("sel_off/sel_scale must be float32")
    if out is not None:
        _check_same_device(cm, vals=out[0], pos=out[1])
        if (out[0].shape != (nlist * p_cap, IVF_PW)
                or out[0].shape != out[1].shape
                or out[0].dtype != torch.float32
                or out[1].dtype != torch.int32
                or out[0].data_ptr() % 16 or out[1].data_ptr() % 16):
            raise ValueError("out must be 16-byte aligned (f32, int32) "
                             f"[nlist * p_cap, {IVF_PW}] tensors")
    lib = LIBRARY.get()
    if out is None:
        out = (torch.empty((nlist * p_cap, IVF_PW), dtype=torch.float32,
                           device=cm.device),
               torch.empty((nlist * p_cap, IVF_PW), dtype=torch.int32,
                           device=cm.device))
    vals, pos = out
    if dw % 4:  # the prober tile comes by TMA: rows of whole 16-byte vectors
        qsel = torch.nn.functional.pad(qsel, (0, -dw % 4))
    sms = torch.cuda.get_device_properties(cm.device).multi_processor_count
    plan = ivf_pool_plan(nlist, cap, p_cap, 4 * dw, sms, probes)
    work = torch.empty((nlist * -(-p_cap // plan.tile_rows) + 1,),
                       dtype=torch.int32, device=cm.device)
    with torch.cuda.device(cm.device):
        stream = torch.cuda.current_stream(cm.device).cuda_stream
        rc = lib.vdb_fused_ivf_pool(
            counts.data_ptr(), qsel.data_ptr(), cm.data_ptr(),
            sel_off.data_ptr(), sel_scale.data_ptr(), work.data_ptr(),
            vals.data_ptr(), pos.data_ptr(), nlist, cap, p_cap, dw,
            qsel.shape[1], winners, plan.tiles, plan.splits, plan.stages,
            int(plan.streamed), stream)
    _raise_on_error(lib, "vdb_fused_ivf_pool", rc)
    _count_launch(fused_ivf_pool)
    return vals, pos


fused_ivf_pool.launches = 0


# --------------------------------------------------------- fused_scan_topk
def _check_scan_topk_args(q, base, b_norms, winners: int,
                          block_n: int) -> None:
    if q.ndim != 2 or base.ndim != 2 or q.shape[1] != base.shape[1]:
        raise ValueError(f"queries {tuple(q.shape)} and base "
                         f"{tuple(base.shape)} must be [*, D] alike")
    if b_norms.shape != (base.shape[0],):
        raise ValueError("b_norms must be [N] like base's rows")
    if q.shape[0] == 0 or base.shape[0] == 0:
        raise ValueError("fused_scan_topk needs queries and rows")
    if winners not in (1, 2):
        raise ValueError(f"winners must be 1 or 2, got {winners}")
    if block_n <= 0 or block_n % LANES:
        raise ValueError(f"block_n={block_n} must be a multiple of {LANES}")


def _scan_buckets(n: int, block_n: int) -> int:
    """Buckets of the reference's grid: N padded to whole column blocks."""
    return -(-n // block_n) * block_n // LANES


def _scan_topk_finish(q, vals, idxs, k: int):
    """The reference's tail (``pallas_kernels.py:1061-1075``): an exact
    top-k over the winners (a stable sort: the lower column wins a tie, as
    ``lax.top_k`` does), -1 where the winner is +inf, + |q|^2 floored at 0,
    padded with (+inf, -1) past the number of winners."""
    k_eff = min(k, vals.shape[1])
    v, arg = torch.sort(vals, dim=1, stable=True)
    v, arg = v[:, :k_eff], arg[:, :k_eff]
    out_i = torch.gather(idxs, 1, arg)
    out_i = torch.where(torch.isfinite(v), out_i, torch.full_like(out_i, -1))
    q_norms = torch.sum(q * q, dim=1, keepdim=True)
    out_d = torch.clamp(v + q_norms, min=0.0)
    out_d = torch.where(out_i >= 0, out_d, float("inf"))
    if k_eff < k:
        out_d = torch.nn.functional.pad(out_d, (0, k - k_eff),
                                        value=float("inf"))
        out_i = torch.nn.functional.pad(out_i, (0, k - k_eff), value=-1)
    return out_d, out_i


def fused_scan_topk_plain(q: torch.Tensor, base: torch.Tensor,
                          b_norms: torch.Tensor, k: int, q_tile: int = 256,
                          block_n: int = 2048, winners: int = 1
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_scan_topk`, on any device: the
    reference's augmented f32 product ``[-2q; 1] . [v; |v|^2]`` per
    ``q_tile`` queries and whole ``block_n`` column blocks (rows past N are
    zeros with a +inf norm), the bucket winners by ``argmin`` (first index
    on ties), then :func:`_scan_topk_finish`."""
    _check_scan_topk_args(q, base, b_norms, winners, block_n)
    qn, d = q.shape
    n = base.shape[0]
    dev = q.device
    bpb = block_n // LANES
    buckets = _scan_buckets(n, block_n)
    vals = torch.empty((qn, buckets * winners), dtype=torch.float32,
                       device=dev)
    idxs = torch.empty((qn, buckets * winners), dtype=torch.int32, device=dev)
    q_aug = torch.cat([-2.0 * q.to(torch.float32),
                       torch.ones((qn, 1), device=dev)], dim=1)
    q_tile = max(1, min(q_tile, qn))
    per = max(1, PLAIN_CHUNK_BYTES // (4 * q_tile * block_n))  # blocks a step
    for j0 in range(0, buckets // bpb, per):
        j1 = min(buckets // bpb, j0 + per)
        r0, r1 = j0 * block_n, min(n, j1 * block_n)
        b_aug = torch.cat([base[r0:r1].to(torch.float32),
                           b_norms[r0:r1, None].to(torch.float32)], dim=1)
        pad = (j1 - j0) * block_n - (r1 - r0)
        if pad:
            tail = torch.zeros((pad, d + 1), device=dev)
            tail[:, d] = float("inf")
            b_aug = torch.cat([b_aug, tail])
        lanes = (r0 + torch.arange((j1 - j0) * bpb, device=dev) * LANES
                 ).view(1, j1 - j0, bpb)
        for q0 in range(0, qn, q_tile):
            s = q_aug[q0:q0 + q_tile] @ b_aug.T
            d3 = s.view(s.shape[0], j1 - j0, bpb, LANES)
            cols_v, cols_i = [], []
            for t in range(winners):
                a = torch.argmin(d3, dim=3, keepdim=True)
                cols_v.append(torch.gather(d3, 3, a)[..., 0])
                cols_i.append(lanes + a[..., 0])
                if t + 1 < winners:
                    d3 = d3.scatter(3, a, float("inf"))
            # block j's columns: winner 0 of its buckets, then winner 1
            c0, c1 = j0 * bpb * winners, j1 * bpb * winners
            vals[q0:q0 + q_tile, c0:c1] = torch.stack(cols_v, 2).reshape(
                s.shape[0], -1)
            idxs[q0:q0 + q_tile, c0:c1] = torch.stack(cols_i, 2).reshape(
                s.shape[0], -1).to(torch.int32)
    return _scan_topk_finish(q.to(torch.float32), vals, idxs, k)


def fused_scan_topk(q: torch.Tensor, base: torch.Tensor,
                    b_norms: torch.Tensor, k: int, q_tile: int = 256,
                    block_n: int = 2048, winners: int = 1
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused f32 distance + bucketed partial top-k over the whole corpus.

    q [Q, D] f32; base [N, D] f32; b_norms [N] squared norms (+inf for rows
    that must never be returned).  Each 128-row bucket keeps ``winners``
    (1 or 2) exact-distance winners; an exact top-k over them plus |q|^2
    gives (sq-dists [Q, k] f32, indices [Q, k] int32) ascending, +inf / -1
    past the winners.  ``block_n`` sets the order of the winner columns
    (the reference's grid, so ties resolve alike) and the plain version's
    column block; ``q_tile`` only the plain version's query tile.

    A CPU tensor runs :func:`fused_scan_topk_plain`; a CUDA tensor runs the
    kernel (``csrc/fused_scan_topk.cu``, f32 FFMA; within the
    summation-order bound of :func:`check_scan_topk`) and counts one launch
    in ``fused_scan_topk.launches``.
    """
    if q.device.type == "cpu":
        return fused_scan_topk_plain(q, base, b_norms, k, q_tile, block_n,
                                     winners)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_scan_topk_args(q, base, b_norms, winners, block_n)
    _check_same_device(q, base=base, b_norms=b_norms)
    if base.dtype != torch.float32 or b_norms.dtype != torch.float32:
        raise TypeError("base and b_norms must be float32")
    qn, d = q.shape
    n = base.shape[0]
    buckets = _scan_buckets(n, block_n)
    qm2 = (-2.0 * q.to(torch.float32)).contiguous()  # exact scaling
    vals = torch.empty((qn, buckets * winners), dtype=torch.float32,
                       device=q.device)
    idxs = torch.empty((qn, buckets * winners), dtype=torch.int32,
                       device=q.device)
    lib = LIBRARY.get()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vdb_fused_scan_topk(
            qm2.data_ptr(), base.data_ptr(), b_norms.data_ptr(),
            vals.data_ptr(), idxs.data_ptr(), qn, n, d, winners,
            block_n // LANES, buckets, stream)
    _raise_on_error(lib, "vdb_fused_scan_topk", rc)
    _count_launch(fused_scan_topk)
    return _scan_topk_finish(q.to(torch.float32), vals, idxs, k)


fused_scan_topk.launches = 0


def _scan_topk_terms(q, base, b_norms, ids):
    """For [Q, k] ids of :func:`fused_scan_topk`: the distance in float64
    and the f32 bound of any summation order of it, 2 (D + 2) 2^-24 times
    the sum of the magnitudes of its terms (2|q|.|v|, |v|^2 and |q|^2, the
    last summed in f32 too)."""
    s = ids.clamp(min=0).long()
    v = base[s].double()                                   # [Q, k, D]
    qd = q.double()[:, None, :]
    vn = b_norms[s].double()
    qn = (qd * qd).sum(-1)
    ref = torch.clamp(vn - 2.0 * (v * qd).sum(-1) + qn, min=0.0)
    terms = 2.0 * (v.abs() * qd.abs()).sum(-1) + vn.abs() + qn
    return ref, 2.0 * (q.shape[1] + 2) * 2.0 ** -24 * terms


def check_scan_topk(kernel, plain, q, base, b_norms) -> dict:
    """Hold :func:`fused_scan_topk` (dists, ids) to its plain version's
    where bit-equality cannot hold (the f32 sums run in another order):

      * the empty entries (+inf, -1) are the same;
      * the ids agree in >= 99.9% of the live entries;
      * each side's distance is within the bound of
        :func:`_scan_topk_terms` (plus one ulp of the final add) of the
        float64 distance of its own id;
      * entry by entry, the two distances differ by at most both entries'
        bounds (a differing id is a near-tie the two orders broke apart).

    Returns the agreement share, the largest |difference| and ``ok``."""
    dk, ik = kernel
    dp, ip = plain
    empty_k, empty_p = ik < 0, ip < 0
    same_empty = bool(torch.equal(empty_k, empty_p)
                      and torch.isinf(dk[empty_k]).all()
                      and torch.isinf(dp[empty_p]).all())
    live = ~empty_p & ~empty_k
    agree = (ik == ip) & live
    share = float(agree.sum()) / max(1, int(live.sum()))
    ref_k, bk = _scan_topk_terms(q, base, b_norms, ik)
    ref_p, bp = _scan_topk_terms(q, base, b_norms, ip)
    dkd, dpd = dk.double(), dp.double()
    ulp = 2.0 ** -23
    ok_k = bool(((dkd - ref_k).abs() <= bk + ulp * dkd.abs())[live].all())
    ok_p = bool(((dpd - ref_p).abs() <= bp + ulp * dpd.abs())[live].all())
    ok_pair = bool(((dkd - dpd).abs()
                    <= bk + bp + ulp * (dkd.abs() + dpd.abs()))[live].all())
    err = float((dk - dp)[live].abs().max()) if live.any() else 0.0
    return {"id_agreement": share, "max_abs_err": err,
            "ok": same_empty and share >= 0.999 and ok_k and ok_p
            and ok_pair}
