"""Chip smoke test of the PyTorch/CUDA port (vector_db_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines (every timing line carries the card's
name and power limit):

  1. device  — CUDA present, TF32 off for f32 matmuls;
  2. build   — the CUDA kernels compiled from vector_db_torch/csrc;
  3. kernel  — fused_int8_pool against its plain PyTorch version on the card
               at the main path's shapes (bit-equal required), and both
               timed at Q=1024, N=1,001,472, d=512, w=2048;
  4. 100k    — the flagship through VectorDatabase: 512-d x 100,000 rows,
               HnswPqConfig(num_subspaces=64, training_samples=20000),
               add_batch through the WAL, auto -> scan_exact, recall@10
               against the exact scan >= 0.99, close + reopen with the same
               ids;
  5. 1M      — the same config at 512-d x 1,000,000 rows by bulk_load of the
               device tensor, auto -> scan_pallas_int8 (the kernel's launch
               count must rise), recall@10 >= 0.95.

Then a JSON line of the kernels, and as the last line
{"ok": true, "device": {...}}.  A failed phase raises and the script exits
non-zero without that line; so does a machine without CUDA.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import torch

DEVICE = "cuda"
K = 10
DIM = 512
NQ = 1024
N_FLAGSHIP = 100_000
N_KERNEL = 1_000_000
CFG = dict(num_subspaces=64, training_samples=20000)
KERNEL_SHAPES_Q = (1, 13, 1024)
KERNEL_SHAPES_W = (64, 2048)
WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                    "chip_smoke")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


CARD = ""


def say(*parts):
    print(*parts, flush=True)


def timing(label, value, unit):
    say(f"[{CARD}] {label}: {value} {unit}")


def cuda_ms(fn, reps=3):
    """Best of ``reps`` CUDA-event timings of fn() after one warm-up."""
    fn()
    best = float("inf")
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return best


def host_s(fn, reps=3):
    """Best of ``reps`` host wall times of fn() (which returns host data,
    so the device work is inside the window) after one warm-up."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def recall(got_ids, gt_ids) -> float:
    return sum(len(set(g) & set(t)) for g, t in zip(got_ids, gt_ids)) / (
        K * len(gt_ids))


def result_ids(results):
    return [[r.id for r in row] for row in results]


def phase_device():
    global CARD
    CARD = card_line()
    say(f"phase 1 device: {torch.cuda.get_device_name(0)} | nvidia-smi: {CARD}"
        f" | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | devices {torch.cuda.device_count()}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    say(f"phase 1 device: matmul.allow_tf32={tf32} "
        f"float32_matmul_precision={prec}")
    if tf32 or prec != "highest":
        raise RuntimeError("TF32 is on for f32 matmuls; the port needs it off")


def phase_build():
    from vector_db_torch.ops.kernels import build_kernels

    t0 = time.perf_counter()
    lib = build_kernels()
    say(f"phase 2 build: {lib.path}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"phase 2 build: ptxas {line.strip()}")
    timing("phase 2 build seconds (nvcc + load)", time.perf_counter() - t0, "s")


def phase_kernel():
    """Kernel vs plain on the card; returns the kernels-line entry."""
    from vector_db_torch.index.hnsw_pq import SHADOW_PAD_ROWS, _build_scan8_shadow
    from vector_db_torch.ops import kernels as kn

    g = torch.Generator(device=DEVICE).manual_seed(3)
    big = 1_000_064  # the 1M store's capacity (rounded to 128)
    corpus = torch.randn(big, DIM, device=DEVICE, generator=g)
    valid = torch.rand(big, device=DEVICE, generator=g) > 0.05  # dead rows
    norms = (corpus * corpus).sum(1)
    shadows = {
        4000: _build_scan8_shadow(corpus[:4000], norms[:4000], valid[:4000],
                                  "l2", 1)[:4],
        1_001_472: _build_scan8_shadow(corpus, norms, valid, "l2",
                                       SHADOW_PAD_ROWS)[:4],
    }
    del corpus, norms, valid
    queries = torch.randn(NQ, DIM, device=DEVICE, generator=g)
    worst = 0.0
    for n, (base8, off, sc, cvec) in shadows.items():
        assert base8.shape[0] == n, (base8.shape, n)
        qc = queries - cvec[None, :]
        for qn in KERNEL_SHAPES_Q:
            for w in KERNEL_SHAPES_W:
                kv, ks = kn.fused_int8_pool(qc[:qn], base8, off, sc, w)
                pv, ps = kn.fused_int8_pool_plain(qc[:qn], base8, off, sc, w)
                torch.cuda.synchronize()
                fin = torch.isfinite(pv)
                err = float((kv[fin] - pv[fin]).abs().max()) if fin.any() else 0.0
                same = torch.equal(kv, pv) and torch.equal(ks, ps)
                say(f"phase 3 kernel: Q={qn} N={n} d={DIM} w={w} "
                    f"pool={tuple(kv.shape)} bit_equal={same} "
                    f"max_abs_err={err} live_slots={int((ks >= 0).sum())}")
                if not same:
                    raise RuntimeError("fused_int8_pool disagrees with its plain "
                                       f"version at Q={qn} N={n} w={w}")
                worst = max(worst, err)
    base8, off, sc, cvec = shadows[1_001_472]
    qc = queries - cvec[None, :]
    plain_ms = cuda_ms(lambda: kn.fused_int8_pool_plain(qc, base8, off, sc, 2048))
    ms = cuda_ms(lambda: kn.fused_int8_pool(qc, base8, off, sc, 2048))
    plain_ms = min(plain_ms, cuda_ms(
        lambda: kn.fused_int8_pool_plain(qc, base8, off, sc, 2048)))
    timing("phase 3 fused_int8_pool kernel Q=1024 N=1001472 d=512 w=2048 "
           "(best of 3)", ms, "ms")
    timing("phase 3 fused_int8_pool plain  Q=1024 N=1001472 d=512 w=2048 "
           "(best of 3)", plain_ms, "ms")
    del shadows, base8, off, sc
    torch.cuda.empty_cache()
    return {"name": "fused_int8_pool", "route": "cuda",
            "source": "vector_db_torch/csrc/fused_int8_pool.cu",
            "replaces": "vector_db_tpu/ops/pallas_kernels.py:585",
            "launches": 0, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def make_db(n, path=None):
    from vector_db_torch import HnswPqConfig, IndexType, VectorDatabase

    b = (VectorDatabase.builder().with_dimension(DIM).with_max_elements(n)
         .with_index_type(IndexType.HNSWPQ)
         .with_index_config(HnswPqConfig(**CFG)).with_device(DEVICE))
    if path:
        b = b.with_storage_path(path)
    return b.build()


def exact_ids(corpus, queries):
    from vector_db_torch.ops.distance import blocked_knn

    valid = torch.ones(corpus.shape[0], dtype=torch.bool, device=DEVICE)
    _, idx = blocked_knn(queries, corpus, valid, K, block_n=131072)
    return idx.cpu().tolist()  # ids are the row numbers


def serve(db, label, queries, gt):
    """Recall, batched QPS and Q=1 latency of db; returns the ids."""
    from vector_db_torch.index.hnsw_pq import _auto_scan_mode

    mode = _auto_scan_mode(db.index.config.use_graph, db.size())
    ids = result_ids(db.search_batch(queries, K))
    rec = recall(ids, gt)
    say(f"phase {label}: rows={db.size()} auto -> {mode} recall@10={rec}")
    t = host_s(lambda: db.search_batch(queries, K))
    timing(f"phase {label} batched QPS (Q={NQ}, k={K}, best of 3)",
           NQ / t, "queries/s")
    lat = sorted(host_s(lambda: db.search_batch(queries[i:i + 1], K), reps=1)
                 for i in range(20))
    timing(f"phase {label} Q=1 latency (median of 20)", lat[10] * 1e3, "ms")
    return mode, rec, ids


def phase_100k():
    from vector_db_torch.ops import kernels as kn

    n = N_FLAGSHIP
    path = os.path.join(WORK, "db100k")
    shutil.rmtree(path, ignore_errors=True)
    corpus = torch.randn(n, DIM, device=DEVICE,
                         generator=torch.Generator(device=DEVICE).manual_seed(42))
    queries = torch.randn(NQ, DIM, device=DEVICE,
                          generator=torch.Generator(device=DEVICE).manual_seed(7))
    gt = exact_ids(corpus, queries)
    db = make_db(n, path)
    t0 = time.perf_counter()
    db.add_batch(range(n), corpus)
    torch.cuda.synchronize()
    timing("phase 4 100k build (add_batch + WAL + train + encode)",
           time.perf_counter() - t0, "s")
    before = kn.fused_int8_pool.launches
    mode, rec, ids = serve(db, "4 100k", queries, gt)
    if mode != "scan_exact" or kn.fused_int8_pool.launches != before:
        raise RuntimeError(f"100k: auto resolved to {mode}, not scan_exact")
    if rec < 0.99:
        raise RuntimeError(f"100k recall@10 {rec} < 0.99")
    t0 = time.perf_counter()
    db.close()
    db = make_db(n, path)
    timing("phase 4 100k close + reopen", time.perf_counter() - t0, "s")
    again = result_ids(db.search_batch(queries, K))
    say(f"phase 4 100k: reopened rows={db.size()} identical_ids={again == ids}")
    if again != ids:
        raise RuntimeError("100k: ids differ after close/reopen")
    db.close()
    shutil.rmtree(path, ignore_errors=True)


def phase_1m():
    from vector_db_torch.ops import kernels as kn

    n = N_KERNEL
    torch.cuda.reset_peak_memory_stats()
    corpus = torch.randn(n, DIM, device=DEVICE,
                         generator=torch.Generator(device=DEVICE).manual_seed(42))
    queries = torch.randn(NQ, DIM, device=DEVICE,
                          generator=torch.Generator(device=DEVICE).manual_seed(7))
    gt = exact_ids(corpus, queries)
    db = make_db(n)
    t0 = time.perf_counter()
    db.bulk_load(range(n), corpus)
    torch.cuda.synchronize()
    timing("phase 5 1M build (bulk_load + train + encode)",
           time.perf_counter() - t0, "s")
    before = kn.fused_int8_pool.launches
    mode, rec, _ = serve(db, "5 1M", queries, gt)
    launched = kn.fused_int8_pool.launches - before
    say(f"phase 5 1M: fused_int8_pool launches during the searches: {launched}")
    if mode != "scan_pallas_int8" or launched == 0:
        raise RuntimeError(f"1M: auto resolved to {mode}; kernel launches "
                           f"{launched}")
    if rec < 0.95:
        raise RuntimeError(f"1M recall@10 {rec} < 0.95")
    timing("phase 5 1M peak device memory",
           torch.cuda.max_memory_allocated() / 2**30, "GiB")
    db.close()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a GPU",
              file=sys.stderr)
        sys.exit(1)
    phase_device()
    phase_build()
    entry = phase_kernel()
    from vector_db_torch.ops import kernels as kn

    # the main path: every launch count starts at 0 here
    kn.fused_int8_pool.launches = 0
    phase_100k()
    phase_1m()
    entry["launches"] = kn.fused_int8_pool.launches
    if entry["launches"] == 0:
        raise RuntimeError("the main path never launched fused_int8_pool")
    shutil.rmtree(WORK, ignore_errors=True)
    say(CARD)
    say(json.dumps({"kernels": [entry]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
