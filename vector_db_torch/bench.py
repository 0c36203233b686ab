"""The flagship benchmark of the port: ``bench.py``'s figures on one GPU.

    python -m vector_db_torch.bench                 # full width, on CUDA
    python -m vector_db_torch.bench --device cpu --n 4096 --dim 64 --nq 64

Drives ``HnswPqIndex`` at the reference bench's configuration: 512-d x
100,000 gaussian rows, 64 subspaces x 8 bits (32x), Q=1024, k=10, rows
drawn on the device from seed 42 and queries from seed 7.  Prints one JSON
line, the last line of its output, with the reference bench's eleven keys
and their meanings:

  * ``value``: batched QPS of the search program the index runs at this
    size (``exact_scan_search``, k=16 as padded), from 120 serialized reps
    (each rep's queries depend on the previous rep's answer, nothing syncs
    inside the loop) bracketed by CUDA events: one warm-up pass, best of 3;
  * ``q1_latency_ms``: the same loop on 8 queries, the batch a single query
    is padded to (``index/base.pad_queries_pow2``);
  * ``adc_fast_qps`` / ``adc_fast_recall_at_10``: the memory-bound mode
    (candidates scored from the codes alone through the decode kernel
    ``ops/kernels.pq_decode_recon_t``, the top 128 re-ranked against bf16
    rows) on the spectral corpus ``randn * (i + 1)^-0.5``;
  * ``recall_at_10``, ``build_seconds``, and the ratios to the reference's
    published 2,391 QPS / 97.6% R@10 (``BASELINE.md``);

and under names of their own the host wall of a whole search: ``index_qps``
(``HnswPqIndex.search_batch``), ``adc_fast_index_qps`` (the memory-bound
index's) and ``db_qps`` (``VectorDatabase.search_batch``, which also builds
the result objects), each best of 3; and ``device``, the card's name and
power limit as nvidia-smi prints them, or ``"cpu"``.

On the CPU (``--device cpu``) torch runs each operation before it returns,
so the loops are timed by the host clock; every figure of such a run
belongs to the CPU, and ``device`` says so.  There is no fallback: any
failure raises (the command exits non-zero and prints no JSON line), and
``--device cuda`` without CUDA raises.  The CUDA and the CPU generators
draw other numbers than the reference's JAX PRNG, so the corpus is another
draw of the same distributions, and exact ground truths are cached under
names that carry this package, the seeds, the device type and a
fingerprint of the draw.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from .api.config import HnswPqConfig
from .api.database import IndexType, VectorDatabase
from .core.device import resolve_device
from .index.hnsw_pq import HnswPqIndex, exact_scan_search
from .ops import kernels
from .ops.adc import adc_fast_search
from .ops.distance import blocked_knn, pack_bf16_rows

METRIC = "hnswpq_flagship_batched_qps_512d_100k_k10"
K = 10
#: the k the index pads k=10 to, at which the timed loops search
K_PAD = 16
ROW_SEED, QUERY_SEED = 42, 7
#: the reference's published single-chip flagship figures (BASELINE.md)
BASELINE_QPS = 2391.0
BASELINE_RECALL = 0.976
#: candidates the memory-bound mode re-ranks exactly
SELECT_R = 128
GT_BLOCK = 16384
DEFAULT_GT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
    "bench_gt")


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_corpus(device, n: int, dim: int, nq: int, spectral: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """([n, dim] rows, [nq, dim] queries) f32, standard normal drawn on
    ``device`` from seeds 42 and 7; ``spectral`` scales dim i by
    (i + 1)^-0.5 (a power-law eigenspectrum, as embedding models emit)."""
    device = torch.device(device)

    def draw(rows, seed):
        gen = torch.Generator(device).manual_seed(seed)
        return torch.randn(rows, dim, device=device, generator=gen)

    rows, queries = draw(n, ROW_SEED), draw(nq, QUERY_SEED)
    if spectral:
        scale = (torch.arange(dim, device=device, dtype=torch.float32)
                 + 1.0) ** -0.5
        rows, queries = rows * scale, queries * scale
    return rows, queries


def gt_path(gt_dir: str, kind: str, rows: torch.Tensor,
            queries: torch.Tensor, k: int) -> str:
    """The cache file of a ground truth: named by this package, the corpus
    kind and shape, k, the seeds, the device type and a fingerprint of the
    draw (its first and last rows), so no truth of another draw is read."""
    digest = hashlib.sha1()
    for t in (rows[:1], rows[-1:], queries[:1], queries[-1:]):
        digest.update(t.cpu().numpy().tobytes())
    n, dim = rows.shape
    return os.path.join(
        gt_dir, f"vector_db_torch_gt_{kind}_{dim}_{n}_{queries.shape[0]}_{k}"
        f"_seeds{ROW_SEED}-{QUERY_SEED}_{rows.device.type}_"
        f"{digest.hexdigest()[:16]}.npy")


def ground_truth(rows: torch.Tensor, queries: torch.Tensor, k: int,
                 gt_dir: str, kind: str) -> np.ndarray:
    """Exact top-k row numbers [nq, k] (``ops/distance.blocked_knn``, blocks
    of 16,384 rows), read from ``gt_dir`` when cached; a missing, truncated
    or misshapen file is computed again and replaced atomically."""
    path = gt_path(gt_dir, kind, rows, queries, k)
    try:
        gt = np.load(path)
        if gt.shape == (queries.shape[0], k) and gt.dtype.kind == "i":
            return gt
    except (OSError, ValueError, EOFError):
        pass
    valid = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    _, idx = blocked_knn(queries, rows, valid, k, block_n=GT_BLOCK)
    gt = idx.cpu().numpy()
    os.makedirs(gt_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, gt)
    os.replace(tmp, path)
    return gt


def recall_at(ids: np.ndarray, gt: np.ndarray) -> float:
    """Mean |ids ∩ gt| / k over the queries (ids are the row numbers)."""
    k = gt.shape[1]
    return float(np.mean([len(set(a[:k].tolist()) & set(b.tolist())) / k
                          for a, b in zip(ids, gt)]))


def flagship_config(dim: int) -> HnswPqConfig:
    """bench.py's flagship: 8 dims a subspace (64 x 8 bits at 512-d)."""
    return HnswPqConfig(num_subspaces=max(1, dim // 8),
                        training_samples=20000)


def membound_config(dim: int) -> HnswPqConfig:
    """bench.py's memory-bound mode: adc_fast, ranked pool, the top 128
    re-ranked against bf16 rows."""
    return HnswPqConfig(num_subspaces=max(1, dim // 8), training_samples=20000,
                        search_mode="adc_fast", adc_pool="approx",
                        adc_select_r=SELECT_R, refine_store="bf16")


def build_index(rows: torch.Tensor, config: HnswPqConfig
                ) -> tuple[HnswPqIndex, float]:
    """An L2 ``HnswPqIndex`` bulk-loaded with ``rows`` (ids = row numbers),
    trained and encoded; returns it with the synchronised build seconds."""
    n, dim = rows.shape
    idx = HnswPqIndex(dim, n, "l2", config, device=rows.device)
    sync(rows.device)
    t0 = time.perf_counter()
    idx.bulk_load(range(n), rows)
    sync(rows.device)
    return idx, time.perf_counter() - t0


def exact_scan(idx: HnswPqIndex, q_n: int):
    """The search program ``search_batch`` runs at this size (scan_exact):
    ``fn(queries) -> (dists, ids)`` at k=16, with the index's block rule for
    a batch of ``q_n``."""
    st = idx.store.state
    block = idx._f32_scan_block(st.capacity, q_n)

    def search(q):
        return exact_scan_search(q, st.vectors, st.norms, st.valid, st.ids,
                                 K_PAD, idx.metric, block)
    return search


def membound_scan(idx: HnswPqIndex):
    """The memory-bound search program: ``adc_fast_search`` on the index's
    decode tables, ranked pool, the top 128 re-ranked against the rows
    packed to bf16, in one chunk (``chunk_n=0``)."""
    st = idx.store.state
    codes_t, cbt, code_norms = idx._fast_tables()
    packed = pack_bf16_rows(st.vectors)

    def search(q):
        return adc_fast_search(
            q, codes_t, cbt, st.valid, st.vectors, st.ids, K_PAD,
            bucket=idx.config.adc_bucket, winners=1, pool_mode="approx",
            code_norms=code_norms, perm=idx.perm, packed_base=packed,
            select_r=SELECT_R)
    return search


def _serial_pass(search, q, reps):
    """``reps`` searches, each on ``q + eps`` where eps is the previous
    answer's first distance x 1e-30 (a 0-d device tensor: zero in effect,
    but the next rep waits for it)."""
    eps = torch.zeros((), dtype=q.dtype, device=q.device)
    for _ in range(reps):
        d, _ = search(q + eps)
        eps = d[0, 0] * 1e-30
    return eps


def _check_no_sync(search, q, reps):
    """One pass with CUDA's sync debug mode on: raises if any rep makes the
    host wait for the card (an ``.item()``, a copy to the host, a
    ``nonzero``), which would time the host's round trips."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _serial_pass(search, q, reps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    if syncs:
        raise RuntimeError(f"the timed loop synchronizes: {syncs[0]}")


def seconds_per_rep(search, q: torch.Tensor, reps: int, passes: int = 3
                    ) -> float:
    """Best of ``passes`` timed passes of ``reps`` serialized searches, per
    rep, after one warm-up pass (on CUDA checked to never sync).  CUDA
    events bracket a pass on the card; the host clock on the CPU."""
    if q.device.type == "cuda":
        search(q)  # first calls: library load, cuBLAS handles
        _check_no_sync(search, q, reps)
    else:
        _serial_pass(search, q, reps)
    sync(q.device)
    best = float("inf")
    for _ in range(passes):
        if q.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            _serial_pass(search, q, reps)
            stop.record()
            torch.cuda.synchronize(q.device)
            took = start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            _serial_pass(search, q, reps)
            took = time.perf_counter() - t0
        best = min(best, took / reps)
    return best


def rep_kernels(search, q: torch.Tensor) -> list:
    """One rep under ``torch.profiler``: its kernels as (device ms, calls,
    name), longest first (empty when the trace holds no device time).  Their
    sum beside the events' time per rep says whether the host's launches
    keep ahead of the card."""
    from torch.profiler import ProfilerActivity, profile

    search(q)
    torch.cuda.synchronize(q.device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        search(q)
        torch.cuda.synchronize(q.device)
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if "CUDA" in str(getattr(ev, "device_type", "")) and us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    return sorted(rows, reverse=True)


def timed_loop(label: str, search, q: torch.Tensor, reps: int) -> float:
    """seconds_per_rep, logged with (on CUDA) one rep's profiled device
    time and its longest kernels beside it."""
    per_rep = seconds_per_rep(search, q, reps)
    note = ""
    if q.device.type == "cuda":
        rows = rep_kernels(search, q)
        if rows:
            dev = sum(r[0] for r in rows)
            longest = ", ".join(f"{ms:.4f} ms {n} x {name[:60]}"
                                for ms, n, name in rows[:4])
            note = (f"; one rep's device time {dev} ms in "
                    f"{sum(r[1] for r in rows)} launches (torch.profiler): "
                    f"the card is busy {dev / (per_rep * 1e3):.3f} of each "
                    f"rep; longest: {longest}")
        else:
            note = "; the profiler saw no device time"
    log(f"{label}: {per_rep * 1e3:.4f} ms a rep of Q={q.shape[0]} "
        f"({reps} serialized reps, best of 3){note}")
    return per_rep


def host_seconds(fn, reps: int = 3) -> float:
    """Best of ``reps`` host walls of fn() (which returns host data, so the
    device work lies inside), after one warm-up call."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def card_name(device: torch.device) -> str:
    """nvidia-smi's "name, power.limit" of the first card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m vector_db_torch.bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--nq", type=int, default=1024)
    p.add_argument("--reps", type=int, default=120,
                   help="serialized searches a timed pass")
    p.add_argument("--gt-dir", default=DEFAULT_GT_DIR,
                   help="where exact ground truths are cached")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark; prints the JSON line last and returns it."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    n, dim, nq, reps = args.n, args.dim, args.nq, args.reps
    card = card_name(device)
    log(f"bench: flagship HNSWPQ {dim}d x {n} rows, "
        f"{max(1, dim // 8)} x 8-bit subspaces, Q={nq}, k={K}, on {card}")

    # ---- the flagship: raw store, auto -> scan_exact at this size
    rows, queries = make_corpus(device, n, dim, nq)
    t0 = time.perf_counter()
    gt = ground_truth(rows, queries, K, args.gt_dir, "gaussian")
    log(f"ground truth: {time.perf_counter() - t0:.1f} s")
    idx, build_s = build_index(rows, flagship_config(dim))
    log(f"build (ingest + train + encode): {build_s:.2f} s, "
        f"trained={idx.trained}, "
        f"ratio={idx.stats()['compression_ratio']}x, "
        f"mode={idx.resolve_mode(idx.size())}")
    recall = recall_at(idx.search_batch(queries, K)[0], gt)
    log(f"Recall@10: {recall:.4f}")
    dt = timed_loop("exact scan", exact_scan(idx, nq), queries, reps)
    q8 = queries[:8]
    dt1 = timed_loop("Q=1 (padded to 8) exact scan",
                     exact_scan(idx, q8.shape[0]), q8, reps)
    index_s = host_seconds(lambda: idx.search_batch(queries, K))
    del idx

    db = (VectorDatabase.builder().with_dimension(dim).with_max_elements(n)
          .with_index_type(IndexType.HNSWPQ)
          .with_index_config(flagship_config(dim)).with_device(device)
          .build())
    try:
        db.bulk_load(range(n), rows)
        db_s = host_seconds(lambda: db.search_batch(queries, K))
    finally:
        db.close()
    del db, rows, queries

    # ---- the memory-bound mode on the spectral corpus
    rows2, queries2 = make_corpus(device, n, dim, nq, spectral=True)
    gt2 = ground_truth(rows2, queries2, K, args.gt_dir, "spectral")
    idx2, build2_s = build_index(rows2, membound_config(dim))
    log(f"memory-bound build: {build2_s:.2f} s, "
        f"mode={idx2.resolve_mode(idx2.size())}")
    recall2 = recall_at(idx2.search_batch(queries2, K)[0], gt2)
    log(f"memory-bound Recall@10: {recall2:.4f}")
    before = kernels.pq_decode_recon_t.launches
    dt2 = timed_loop("memory-bound adc_fast", membound_scan(idx2), queries2,
                     reps)
    decodes = kernels.pq_decode_recon_t.launches - before
    if device.type == "cuda" and decodes < reps:
        raise RuntimeError(f"the memory-bound loop launched "
                           f"pq_decode_recon_t {decodes} times (< {reps})")
    adc_index_s = host_seconds(lambda: idx2.search_batch(queries2, K))

    result = {
        "metric": METRIC,
        "value": nq / dt,
        "unit": "QPS",
        "vs_baseline": nq / dt / BASELINE_QPS,
        "recall_at_10": recall,
        "baseline_recall_at_10": BASELINE_RECALL,
        "build_seconds": build_s,
        "q1_latency_ms": dt1 * 1e3,
        "adc_fast_qps": nq / dt2,
        "adc_fast_recall_at_10": recall2,
        "adc_fast_vs_baseline": nq / dt2 / BASELINE_QPS,
        "index_qps": nq / index_s,
        "adc_fast_index_qps": nq / adc_index_s,
        "db_qps": nq / db_s,
        "device": card,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
