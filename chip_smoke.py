"""Chip smoke test of the PyTorch/CUDA port (vector_db_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines (every timing line carries the card's
name and power limit):

  1. device  — CUDA present, TF32 off for f32 matmuls;
  2. build   — the CUDA kernels compiled from vector_db_torch/csrc, with
               every ptxas line on registers, spills, a "Performance"
               advisory or a C75xx wgmma advisory;
  3. kernels — each kernel against its plain PyTorch version on the card at
               the main path's shapes, both timed (CUDA events, warm-up,
               best of 3); bit-equal required of the integer and gather
               kernels, and of the bf16 pools agreement within the f32
               summation-order bound (ops/kernels.check_float_pool):
               a. fused_int8_pool at Q in {1, 13, 1024}, w in {64, 2048},
                  N in {4000, 1,001,472}, d=512; timed at Q=1024 and Q=1,
                  at forced pass-split counts beside ops/kernels.pool_splits'
                  plan and at forced ring depths beside S8_POOL_STAGES;
               b. pq_decode_recon_t at S=64, sd=8, K=256, N=524,288;
               c. fused_packed_pool at Q=1024, N=1,001,472, d=512, w=2048
                  (and an N that w does not divide must raise); timed at
                  Q=1024 and Q=1;
               d. fused_int8g_pool at Q in {1, 13, 1024}, w in {64, 2048},
                  N=1,001,472 with dead slots (bit-equal); timed at Q=1024
                  and Q=1;
               e. fused_raw_pool at the shapes of d, and at the ragged
                  shapes Q in {1, 13, 129, 1024} x d in {32, 96, 512, 592}
                  with N = 5003 (not a multiple of the pool width); timed
                  at Q=1024 and Q=1, and at forced pass-split counts beside
                  ops/kernels.pool_splits' plan (within the bound);
               f. fused_adc_pool at S=64, sd=8, K in {256, 200}, N in
                  {4000, 524,288}, Q in {1, 1024}, w = N / 32, and at the
                  ragged shapes Q in {1, 13, 129, 1024} x (S, sd) giving d
                  in {32, 96, 512, 592} with codebook entries of 2, 4, 8,
                  16 and 32 bytes, K=200, N = 5003; timed at Q=1024 and
                  Q=1, and at forced pass-split counts (within the bound);
               g. fused_ivf_pool at the 1M scan_ivf shape (nlist=513,
                  cap=2688, p_cap=512, d=512, winners 4, 2, 1) with dead
                  positions, unprobed clusters and part-filled prober tiles,
                  at Q=1's shape (p_cap=32, 64 probed clusters), at p_cap
                  32 and 64 with prober counts that end mid-tile, at one
                  bucket a cluster (cap=128) and a full pool row (cap=4096,
                  winners 4) and at the 10M grid's shape (nlist=4864,
                  p_cap=64, ~6.7 GB of rows built on the card): bit-equal on
                  the rows the merge reads, with and without the caller's
                  probe count, and the rows no merge reads (at or past a
                  cluster's count, of unprobed clusters) keep the sentinel
                  they were filled with; timed at Q=1024 and at Q=1's shape
                  (at forced ring depths and bucket splits beside the
                  plan's) and at the 10M grid;
               h. fused_scan_topk at Q in {13, 1024}, N in {4000, 100,000},
                  d=512, k=10, winners in {1, 2}, rows masked by a +inf norm
                  (within the bound of ops/kernels.check_scan_topk); it has
                  no index caller in either package, so no path launches
                  it: its entry reports the path's 0 launches with
                  "no_index_caller": true, and one self-test call's count
                  is printed on a line of its own;
               i. rows of any width: the six pools at d in {768, 1536}
                  (the s8 pools also at 516, rows that are not whole
                  16-byte vectors: the cp.async producer; the bf16 pools
                  past 640 dims: the streamed query tile) on small stores,
                  bit-equal or within the bound, each timed at Q=1024;
  4. 100k    — the flagship through VectorDatabase: 512-d x 100,000 rows,
               HnswPqConfig(num_subspaces=64, training_samples=20000),
               add_batch through the WAL, auto -> scan_exact, recall@10
               against the exact scan >= 0.99, close + reopen with the same
               ids;
  5. 1M      — the same config at 512-d x 1,000,000 rows by bulk_load of the
               device tensor, auto -> scan_pallas_int8 (fused_int8_pool must
               launch), then on the same database scan_pallas
               (fused_raw_pool), scan_pallas_int8 with
               int8_epilogue="global" (fused_int8g_pool) and scan_bf16 (no
               pool kernel), each recall@10 >= 0.95, the index time and a
               profiled search of each pool mode, and CRUD in the two new
               kernel modes;
  6. 10M     — the compressed tier through VectorDatabase with the config
               of benchmarks/bench_10m_api.py:91-103 (raw_store=False,
               proxy_dims=64, search_mode="pca", pca_r=512,
               adc_pool="approx", adc_select_r=512, refine_residual=True),
               the mode set per search as that script does:
               9,961,472 x 512 spectral rows by bulk_load_stream in 76
               chunks of 131,072, exact ground truth merged per chunk;
               auto -> adc_fast (pq_decode_recon_t must launch), recall@10
               >= 0.94; scan_pallas_int8 (fused_packed_pool must launch),
               recall@10 >= 0.96; adc_fast with adc_pool="fused"
               (fused_adc_pool must launch), recall@10 >= 0.94; pca (the
               chunked proxy scan: Q N 4 = 40 GB > 6 GB; no kernel),
               recall@10 >= 0.92 (TPU reference 94.35%), with the proxy's
               bytes and the peak memory; the index time and a profiled
               search of each; CRUD at 10M live, under pca too;
  7. 100k memory-bound — the raw store with search_mode="adc_fast",
               adc_pool="approx", adc_select_r=128, refine_store="bf16" on
               512-d x 100,000 spectral rows by bulk_load
               (pq_decode_recon_t must launch), recall@10 >= 0.96; then
               adc_pool="fused" (fused_adc_pool must launch), >= 0.96;
  8. scan_ivf 1M — the cluster-pruned tier through VectorDatabase on
               1,048,576 x 512 spectral rows (BENCH_REPORT.md:214-251,
               benchmarks/bench_scan_ivf.py): a. compressed + residual by
               bulk_load_stream (8 chunks of 131,072), nlist=0 (auto),
               nprobe=64, fused_ivf_pool must launch and no other pool
               kernel, recall@10 >= 0.93, a profiled index search, and CRUD
               (300 adds found from the exact overlay, a removed id gone, the
               overlay budget crossed -> relayout); b. the raw store by
               bulk_load, recall@10 >= 0.93; c. the compressed + residual
               store at 9,961,472 rows (phase 6's corpus, streamed again with
               the coarse quantizer trained in the stream; phase 6's ground
               truth), nlist auto, at nprobe 64 (db QPS, Q=1 latency, index
               time, profiled searches at Q=1024 and Q=1), 128 and 256:
               fused_ivf_pool must launch and no other pool kernel, and
               recall@10 must rise with nprobe (no reference figure exists
               at this size, so it has no floor of its own); then the coarse
               quantizer trained again on a sample of the whole store (the
               stream trains it on its first chunk), for the recall that
               costs;
  9. the table scan, the proxy and the graph, through VectorDatabase:
               a. adc: search_mode="adc" (refine_k=1024) on the 100k
                  memory-bound corpus of phase 7, Q=1024 and Q=1, k=10:
                  exhaustive (flagship_search) and nlist=1024, nprobe=64
                  (flagship_search_pruned), on the raw store and on
                  raw_store=False, refine_residual=True; no reference figure
                  exists, so each floor is what this script measured on an
                  H100 less 0.01, printed beside the same index's recall
                  under phase 7's adc_fast settings;
                  then ops/adc.adc_decode_topk against adc_scan_topk on the
                  index's codes (pq_decode_recon_t must launch; distances
                  within 2e-2 relative, the bf16 rounding);
               b. pca: the same corpus, proxy_dims=64, pca_r 128 and 256
                  (floors 0.96 / 0.97; TPU reference 97.35% / 98.22%) under
                  L2, and pca_r=256 under cosine (floor 0.97);
               c. graph: (i) IndexType.HNSW, 128-d x 10,000 gaussian rows,
                  ef_search 128 and 400 (floors 0.90 / 0.97; TPU reference
                  93.1% / 98.8%); (ii) IndexType.HNSW, 512-d x 100,000
                  gaussian rows: the from-scratch build (bulk_build), 10,000
                  adds in batches of 100 under insert_policy="defer" (ms/row
                  amortised with the flush, p50 / p99 per add_batch), every
                  added id found by its own vector before the flush (the
                  exact overlay: all) and after (the graph's top-1 recall on
                  these rows: measured less 0.01), recall@10 at the
                  adaptive ef >= 0.85 (TPU reference 89.3%), the entry point
                  deleted, close + reopen with the same ids; (iii)
                  IndexType.HNSWPQ, use_graph=True, refine_k=64 on the
                  flagship 100k by bulk_load: ADC traversal + exact re-rank
                  at ef_search 64 and 256 (floors: measured less 0.01), 2,000
                  adds answered through the pending overlay; (iv) the
                  sequential insert path (insert_policy="stream",
                  bulk_build=False) at 4,096 x 128-d rows: ms/row, recall@10
                  >= the bulk-built graph's less 0.02;
               with one profiled index.search_batch (device ms, idle
               share, launches) at Q=1024 and Q=1 for adc exhaustive and
               pruned (raw store), each pca case, HNSW (i) at ef 400 and
               (ii) after the flush, and the ADC traversal at ef 256.

 10. the other index types, through their indexes at
               benchmarks/full_bench.py's configurations (rows bulk-loaded,
               then build(); numpy gaussian rows, seeds 42 / 7 at 512-d and
               1 / 2 at 128-d; Q=256, k=10; each floor a point or three
               under the TPU reference of BENCH_REPORT.md, printed beside
               it):
               a. flat PQ, PqConfig(num_subspaces=64, training_iterations=10,
                  refine_k=512) at 512-d x 10,000 (floor 0.90; then
                  refine_k=0, printed), and at 100,000 rows with Q=1024
                  (pq_decode_recon_t must launch; its launches printed);
                  pq_decode_recon_t bit-equal to its plain version at
                  N=100,000, adc_decode_topk against adc_scan_topk (shared
                  slots, max relative distance error < 2e-2);
               b. IVF, IvfConfig(num_clusters=100, num_probes=10) at 128-d x
                  10,000, nprobe 5 / 10 / 20 / 50 (floor 0.90 at 10), and
                  the default config at 512-d x 100,000: candidates a query,
                  profiled searches at Q=256 and Q=1, peak memory;
               c. LSH, LshConfig(backfill=False) at 512-d x 100,000
                  isotropic (0.70), 128-d x 10,000 (0.90) and 512-d x
                  100,000 spectral (0.96): the calibrated tables, bits and
                  radius, the short rows;
               d. Annoy, AnnoyConfig(backfill=False) at 128-d x 10,000
                  (0.95; then backfill on) and 512-d x 100,000 (0.80): host
                  build seconds, descent ms and chunks, candidates a query;
               e. PQ, IVF, LSH and ANNOY through VectorDatabase with a
                  storage path (add, rebuild, add, delete, search, close,
                  reopen: the same ids), then
                  vector_db_torch/examples/text_search_example.main() at
                  its default sizes on the card (seven index types).

 11. the sharded tier (vector_db_torch/parallel/sharded.py, ShardedDatabase,
               one controller; the shards are logical shards of the card):
               a. the raw tier, 1,048,576 x 512 gaussian rows, Q=1024 and
                  Q=1: on a mesh of one shard search -> fused
                  (fused_int8_pool must launch, recall@10 >= 0.95), again
                  with int8_epilogue="global" (fused_int8g_pool), train_pq
                  (S=64, K=256) + search_flagship(refine=1024)
                  (pq_decode_recon_t), fit_pca(128) + search_pca(256), and
                  a CRUD round (1% removed, 10,000 added: each found by its
                  own vector, no removed id returned); on four shards of
                  262,144 search -> exact (recall@10 >= 0.99, ids equal to
                  the single-chip exact top-10 apart from distance ties) and
                  search_fused (four fused_int8_pool launches a call);
               b. the compressed tier with refine_residual and
                  host_mirror=False on phase 6's corpus (9,961,472 rows by
                  bulk_load_stream, its ground truth) over four shards:
                  search -> fused (fused_packed_pool, >= 0.96),
                  search_flagship (pq_decode_recon_t), search_pca, the exact
                  int8 scan; save (payload_sharded) and load onto one shard
                  with the seconds and the host RSS peak of each; the exact
                  scan's ids and distances identical after the reload;
               each search with its recall, host wall (best of 3), Q=1 time,
               a profiled call (device ms, launches, idle) and the peak
               device memory; flagship and pca floors are what this script
               measured on an H100 less 0.01 (SHARDED_FLOORS).
 12. the multi-process sharded path, the graft entry and the last examples:
               a. vector_db_torch/examples/multiprocess_dcn.main over a
                  file:// NCCL group of one rank holding 4 shards of the card
                  (262,144 x 512 rows each, phase 11a's size): its ids and
                  distances bit-equal to sharded_knn on the single-controller
                  mesh [cuda:0] * 4 over the same rows; sharded_cond_raw8 +
                  sharded_fused_raw8 over the spanning mesh (fused_int8_pool,
                  four launches a call), its ids equal to the single
                  controller's and recall@10 >= 0.95 against the exact
                  search; host walls at Q=64 and Q=1024, a profiled call;
               b. two ranks spawned (torch.multiprocessing) under a gloo
                  group on the one card, 2 of 12a's shards each: every rank
                  returns 12a's ids and distances (the example, exact,
                  fused); host walls with the winners through host memory;
               c. vector_db_torch/graft_entry: entry() (shapes (8, 8), valid
                  ids), then dryrun_multichip(4) on [cuda:0] * 4 at the
                  reference's own tiny shapes (fused_int8g_pool,
                  fused_packed_pool and pq_decode_recon_t must launch);
               d. vector_database_example at 10,000 x 128 (seven index types;
                  pq_decode_recon_t must launch) and compression_example at
                  10,000 x 512 (eight presets; pq_decode_recon_t and
                  fused_packed_pool must launch), each table printed, BRUTE
                  exact and every row at its floor (EXAMPLE_FLOORS: this
                  script's first full run on an H100 less 0.01).

 13. the reference's cross-cutting suites (tests/test_oracle_fuzz.py,
               test_robustness.py, test_round2_fixes.py-test_round5_fixes.py,
               test_native_storage.py) at 100k x 512 through the kernels:
               a. CRUD against a float64 oracle (plain torch on the card)
                  after churn: add 100,000 -> delete 10,000 -> re-add 2,000
                  of the deleted ids (1,024 of them x10, past 1% of the
                  live rows, so the global shadow's clip rebuild runs) ->
                  reload (close, then build from the storage path) -> add
                  20,000 -> delete 10,000 on five databases (raw L2 and raw
                  cosine on the flagship's gaussian rows, compressed and
                  compressed + residual on the same, raw L2 with nlist 256
                  on the memory-bound spectral rows); after every step
                  1,024 noisy copies of live rows (sigma 0.01) and 16
                  single queries in each mode: scan_pallas_int8 per-row
                  L2 and cosine (fused_int8_pool), global
                  (fused_int8g_pool), scan_pallas (fused_raw_pool) and
                  compressed + residual (fused_packed_pool) by the
                  exact-set rule of test_oracle_fuzz.py:24-51 over the pool
                  the search scored, with the rule over the whole live set
                  printed (a 2,048-bucket pool keeps one row of ~50), the
                  raw stores' distances equal to the oracle's; compressed
                  (fused_packed_pool), adc_fast (pq_decode_recon_t), fused
                  (fused_adc_pool) and scan_ivf at nprobe 32
                  (fused_ivf_pool) at PERF.md's floor and at a fresh
                  build's recall less 0.01; no dead id, no -1, ascending
                  distances; after the last step the raw shadows against
                  the store requantized under their cached conditioning,
                  and each kernel against its plain version at the
                  arguments of its mode's last search;
               b. 1, 2, 4 and 8 threads x 4 search_batch calls bit-equal to
                  one thread (raw scan_pallas_int8, compressed +
                  residual), then a writer (add_batch of 1,000, 500
                  delete_vector, rebuild_index) racing 4 searchers, again
                  with one searcher on a CUDA stream of its own: every row
                  sorted, free of -1 and of ids deleted before its search
                  began, every added id first for its own vector;
               c. two children (durability "flush" and "fsync") build a
                  CUDA VectorDatabase with a storage path, take 100,000
                  rows by add_batch, 1,000 add_vector and 100
                  delete_vector, print each acknowledged op and SIGKILL
                  themselves; reopened on the card, every acknowledged add
                  is there (get_vector bit-equal, first for its own
                  vector) and no acknowledged delete;
               d. IndexType.HNSW at 4,096 x 128 with flush_min=512 and
                  flush_chunk=256, batches of 256: no add_batch connects
                  more than flush_chunk rows, every pending row is first
                  for its own vector, recall@10 within 0.02 of full
                  flushes.
 14. the flagship benchmark: vector_db_torch.bench.main([]) in-process at
               its defaults (bench.py's configuration: 512-d x 100,000
               gaussian rows, 64 x 8-bit subspaces, Q=1024, k=10; the
               memory-bound adc_fast on the spectral rows), its JSON line
               printed as "bench: {...}"; recall_at_10 >= 0.99 and
               adc_fast_recall_at_10 >= 0.96 (PERF.md section 2);
               pq_decode_recon_t launched, and bit-equal to its plain
               version on the last decode of the bench's memory-bound
               search ([64, 100,096] codes, the capacity rounded to 128).

Every path of phases 4-14 runs with all kernel launch counts set to 0 just
before it and read just after.  Then a JSON line of the kernels (each with
its time, its plain version's, its launches on the main path, its bound at
the timed shape: the larger of its bytes over 3.35 TB/s and its operations
over the peak of their type, and a library call's time where one PyTorch
call computes the same function, else null), and as the last line
{"ok": true, "device": {...}}.  A failed phase raises and the
script exits non-zero without that line; so does a machine without CUDA.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# the H100 SXM's published peaks (NVIDIA's data sheet, dense, 700 W)
from perfbench.roofline import HBM_BYTES_S, PEAK_OPS_S

DEVICE = "cuda"
K = 10
DIM = 512
NQ = 1024
N_FLAGSHIP = 100_000
N_KERNEL = 1_000_000
CFG = dict(num_subspaces=64, training_samples=20000)
KERNEL_SHAPES_Q = (1, 13, 1024)
KERNEL_SHAPES_W = (64, 2048)
PACKED_SHAPES_N = (4096, 1_001_472)
PACKED_SHAPES_W = (512, 2048)
DECODE_SHAPES = ((64, 8), (16, 4))  # (S, sd)
DECODE_SHAPES_K = (256, 200)
DECODE_SHAPES_N = (4000, 524_288)
ADC_SHAPES_K = (256, 200)
ADC_SHAPES_N = (4000, 524_288)
ADC_SHAPES_Q = (1, 1024)
ADC_BUCKET = 32
RAGGED_Q = (1, 13, 129, 1024)
RAGGED_N = 5003
RAGGED_RAW_D = (32, 96, 512, 592)
#: (S, sd): d = 32, 96, 512, 592 with entries of 4, 2, 8, 16 and 32 bytes
RAGGED_ADC = ((16, 2), (96, 1), (128, 4), (74, 8), (37, 16))
N_10M_CHUNK = 131_072
N_10M_CHUNKS = 76
CFG_10M = dict(raw_store=False, num_subspaces=64, training_samples=20000,
               proxy_dims=64, search_mode="pca", pca_r=512,
               adc_pool="approx", adc_select_r=512, refine_residual=True)
CFG_MEMBOUND = dict(num_subspaces=64, training_samples=20000,
                    search_mode="adc_fast", adc_pool="approx",
                    adc_select_r=128, refine_store="bf16")
N_IVF_CHUNKS = 8  # x 131,072 = 1,048,576 rows
CFG_IVF = dict(raw_store=False, refine_residual=True, search_mode="scan_ivf",
               nlist=0, nprobe=64, num_subspaces=64, training_samples=20000)
CFG_IVF_RAW = dict(search_mode="scan_ivf", nprobe=64, num_subspaces=64,
                   training_samples=20000)
#: phase 9a: recall@10 floors of search_mode="adc" by (store, nlist): what
#: this script measured on an H100 less 0.01 (no reference figure exists)
CFG_ADC = dict(num_subspaces=64, training_samples=20000, search_mode="adc",
               refine_k=1024, nprobe=64)
ADC_FLOORS = {("raw", 0): 0.9899, ("raw", 1024): 0.9047,
              ("int8_resid", 0): 0.9898, ("int8_resid", 1024): 0.9179}
CFG_PCA = dict(num_subspaces=64, training_samples=20000, search_mode="pca",
               proxy_dims=64)
PCA_FLOORS = {("l2", 128): 0.96, ("l2", 256): 0.97, ("cosine", 256): 0.97}
#: phase 9c (iii): ADC traversal, refine_k=64 so that ef_search sets the beam
CFG_GRAPH_PQ = dict(num_subspaces=64, training_samples=20000, use_graph=True,
                    refine_k=64, ef_search=64)
GRAPH_PQ_FLOORS = {64: 0.2975, 256: 0.4018}
N_HNSW_SMALL, DIM_HNSW_SMALL = 10_000, 128
N_HNSW_ADDS = 10_000
#: 9c (ii): share of the flushed rows a search by their own vector must
#: return first (what this script measured on an H100 less 0.01)
OWN_VECTOR_FLOOR = 0.7374
N_STREAM = 4_096
#: phase 10: the other index types at benchmarks/full_bench.py's
#: configurations, Q=256 (full_bench's batch for these cells)
NQ_INDEX = 256
N_INDEX_SMALL, N_INDEX = 10_000, 100_000
CFG_PQ = dict(num_subspaces=64, training_iterations=10, refine_k=512)
IVF_NPROBES = (5, 10, 20, 50)
#: recall@10 floors: a point or three under the TPU reference's figure
#: (BENCH_REPORT.md), which is printed beside each
INDEX_FLOORS = {"pq": (0.90, 0.927), "ivf": (0.90, 0.920),
                "lsh 512 iso": (0.70, 0.727), "lsh 128": (0.90, 0.928),
                "lsh 512 spectral": (0.96, 0.983),
                "annoy 128": (0.95, 0.974), "annoy 512": (0.80, 0.830)}
IVF_SHAPE = dict(nlist=513, cap=2688, p_cap=512, d=512)  # the 1M grid
SCAN_SHAPES_Q = (13, 1024)
SCAN_SHAPES_N = (4000, 100_000)
#: phase 3i: the widths past the old limits, and the stores they run on
WIDE_D = (516, 768, 1536)
WIDE_N = 65_536
WIDE_Q = (13, 1024)
SPLIT_SWEEP = (1, 2, 4, 8, 16, 32)
STAGE_SWEEP = (3, 4, 6, 8, 9)
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "fused_int8_pool": ("vector_db_torch/csrc/fused_int8_pool.cu",
                        "vector_db_tpu/ops/pallas_kernels.py:585"),
    "pq_decode_recon_t": ("vector_db_torch/csrc/pq_decode.cu",
                          "vector_db_tpu/ops/pallas_kernels.py:174"),
    "fused_packed_pool": ("vector_db_torch/csrc/fused_int8_pool.cu",
                          "vector_db_tpu/ops/pallas_kernels.py:900"),
    "fused_int8g_pool": ("vector_db_torch/csrc/fused_int8_pool.cu",
                         "vector_db_tpu/ops/pallas_kernels.py:726"),
    "fused_raw_pool": ("vector_db_torch/csrc/fused_raw_pool.cu",
                       "vector_db_tpu/ops/pallas_kernels.py:460"),
    "fused_adc_pool": ("vector_db_torch/csrc/fused_adc_pool.cu",
                       "vector_db_tpu/ops/pallas_kernels.py:284"),
    "fused_ivf_pool": ("vector_db_torch/csrc/fused_ivf_pool.cu",
                       "vector_db_tpu/ops/pallas_kernels.py:1153"),
    "fused_scan_topk": ("vector_db_torch/csrc/fused_scan_topk.cu",
                        "vector_db_tpu/ops/pallas_kernels.py:988"),
}
POOL_KERNELS = ("fused_int8_pool", "fused_packed_pool", "fused_int8g_pool",
                "fused_raw_pool", "fused_adc_pool", "fused_ivf_pool")
#: kernels without an index caller in either package: the main path cannot
#: launch them, so their reported launches are the path's (0), they carry
#: "no_index_caller": true, and the never-launched check names them out
NO_INDEX_CALLER = ("fused_scan_topk",)
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
    fn = ""
    for line in lib.build_log.splitlines():
        if "Function properties for " in line:
            fn = line.split("Function properties for ")[1].strip()
        if any(k in line for k in ("registers", "spill", "Performance",
                                   "C75")):
            say(f"phase 2 build: ptxas [{kernel_name(fn)}] {line.strip()}")
    timing("phase 2 build seconds (nvcc + load)", time.perf_counter() - t0, "s")
    sass_mix(lib.path, "ivf_pool_kernel")


def sass_mix(lib_path, kernel):
    """The instruction mix of a kernel's SASS (cuobjdump, where the toolkit
    has it): instructions by pipe class, printed.  The compare/select/
    integer class runs at half the FP32 rate on an H100."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        say(f"phase 2 build: sass [{kernel}] not measured (no cuobjdump)")
        return
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300).stdout
    import re

    for part in out.split("Function : ")[1:]:
        name = part.split("\n", 1)[0]
        if kernel not in name:
            continue
        ops = re.findall(
            r"/\*[0-9a-f]{4,5}\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_]+)", part)
        mix = {"total": len(ops)}
        for cls, names in (
                ("compare_select_int", (
                    "FSETP", "FSEL", "SEL", "ISETP", "LOP3", "SHF", "IADD3",
                    "FMNMX", "IMNMX", "I2FP", "I2F", "PLOP3", "LEA", "VIADD")),
                ("fp32_fma_imad", ("FADD", "FMUL", "FFMA", "IMAD")),
                ("shuffle", ("SHFL",)),
                ("load_store", ("LDS", "STS", "LDG", "STG", "LD", "ST", "LDC",
                                "ULDC"))):
            mix[cls] = sum(o in names for o in ops)
        say(f"phase 2 build: sass [{kernel_name(name)}] {json.dumps(mix)}")


def kernel_name(mangled):
    """A mangled kernel name cut to what tells the kernels apart: the
    kernel's name and, for the wgmma tile loop, its producer and epilogue
    (e.g. pool_kernel<TmaRows,Scaled>)."""
    import re

    ids, i = [], 0
    while i < len(mangled):  # the <length><identifier> parts
        if mangled[i].isdigit():
            j = i
            while j < len(mangled) and mangled[j].isdigit():
                j += 1
            ids.append(mangled[j:j + int(mangled[i:j])])
            i = j + int(mangled[i:j])
        else:
            i += 1
    name = next((x for x in ids if x.endswith("_kernel")), mangled[:60])
    args = [x for x in ids if x in ("TmaRows", "CopyRows", "Scaled", "Global",
                                    "RawRows")]
    args += [f"AdcDecode<{u}>" for u in re.findall(r"AdcDecodeILi(\d+)E",
                                                   mangled)]
    return f"{name}<{','.join(args)}>" if args else name


def phase_kernel():
    """Kernel vs plain on the card; returns the kernels-line entry."""
    from vector_db_torch.index.hnsw_pq import SHADOW_PAD_ROWS, _build_scan8_shadow
    from vector_db_torch.ops import kernels as kn

    g = torch.Generator(device=DEVICE).manual_seed(3)
    big = -(-N_KERNEL // 128) * 128  # the 1M store's capacity
    corpus = torch.randn(big, DIM, device=DEVICE, generator=g)
    valid = torch.rand(big, device=DEVICE, generator=g) > 0.05  # dead rows
    norms = (corpus * corpus).sum(1)
    full = _build_scan8_shadow(corpus, norms, valid, "l2",
                               SHADOW_PAD_ROWS)[:4]  # 1,001,472 rows
    shadows = {
        4000: _build_scan8_shadow(corpus[:4000], norms[:4000], valid[:4000],
                                  "l2", 1)[:4],
        full[0].shape[0]: full,
    }
    del corpus, norms, valid
    queries = torch.randn(NQ, DIM, device=DEVICE, generator=g)
    worst = 0.0
    for n, (base8, off, sc, cvec) in shadows.items():
        assert base8.shape[0] == n, (base8.shape, n)
        qc = queries - cvec[None, :]
        for qn in KERNEL_SHAPES_Q:
            for w in KERNEL_SHAPES_W:
                worst = max(worst, hold_s8_pool(
                    f"phase 3 kernel: Q={qn} N={n} d={DIM} w={w}",
                    kn.fused_int8_pool(qc[:qn], base8, off, sc, w),
                    kn.fused_int8_pool_plain(qc[:qn], base8, off, sc, w)))
    base8, off, sc, cvec = full
    n = base8.shape[0]
    qc = queries - cvec[None, :]
    ms, plain_ms = timed_pair(
        "phase 3 fused_int8_pool", f"Q={NQ} N={n} d={DIM} w=2048",
        lambda: kn.fused_int8_pool(qc, base8, off, sc, 2048),
        lambda: kn.fused_int8_pool_plain(qc, base8, off, sc, 2048))
    q1_ms = q1_time("phase 3 fused_int8_pool", f"N={n} d={DIM} w=2048",
                    lambda: kn.fused_int8_pool(qc[:1], base8, off, sc, 2048))
    split_sweep("phase 3 fused_int8_pool", (1024, 129, 1), SPLIT_SWEEP,
                lambda qn: kn.fused_int8_pool(qc[:qn], base8, off, sc, 2048))
    stage_sweep("phase 3 fused_int8_pool",
                lambda: kn.fused_int8_pool(qc, base8, off, sc, 2048))
    b = bound("phase 3 fused_int8_pool", n * DIM + 8 * n + 4 * NQ * DIM
              + 8 * NQ * 2048, 2 * NQ * n * DIM, "int8")
    q8 = torch.randint(-127, 128, (NQ, DIM), device=DEVICE, dtype=torch.int8)
    product_only(f"phase 3 torch._int_mm [{NQ}, {DIM}] x [{DIM}, {n}]",
                 lambda: torch._int_mm(q8, base8.T))
    del shadows, full, base8, off, sc, q8
    torch.cuda.empty_cache()
    return kernel_entry("fused_int8_pool", worst, ms, plain_ms, b,
                        q1_ms=q1_ms)


def per_call_ms(run, calls):
    """CUDA-event time of one call: ``calls`` calls in a row over their
    count (best of 3 windows).  At small Q one call alone would time the
    host launching the wrapper's small kernels onto an idle card."""
    def many():
        for _ in range(calls):
            run()
    return cuda_ms(many) / calls


def ahead_ms(run, calls=20, reps=3):
    """The card's time for one call when the host runs ahead of it: each
    window's first event is queued behind a long matmul, so the ``calls``
    calls are enqueued while the card is still busy and run back to back
    (best of ``reps`` windows over their count).  For a kernel so short
    that :func:`per_call_ms` times the host's launches instead."""
    big = torch.randn(8192, 8192, device=DEVICE)
    run()
    best = float("inf")
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.mm(big, big)
        e0.record()
        for _ in range(calls):
            run()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1) / calls)
    return best


def q1_time(label, shape, run, calls=20):
    """A kernel's time at Q=1 (:func:`per_call_ms`), printed."""
    ms = per_call_ms(run, calls)
    timing(f"{label} kernel Q=1 {shape} (best of 3 windows of {calls} "
           "calls)", ms, "ms")
    return ms


def stage_sweep(label, run, knob="S8_POOL_STAGES"):
    """Kernel time of an s8 pool at forced ring depths beside the default
    (ops/kernels.S8_POOL_STAGES, or IVF_POOL_STAGES for the cluster scan;
    the plan caps a depth at what fits), printed: the measurement behind
    that default."""
    from vector_db_torch.ops import kernels as kn

    default = getattr(kn, knob)
    try:
        times = {"default": cuda_ms(run)}
        for st in STAGE_SWEEP:
            setattr(kn, knob, st)
            times[st] = cuda_ms(run)
    finally:
        setattr(kn, knob, default)
    timing(f"{label} Q={NQ} ms by ring stages (best of 3)", json.dumps(times),
           "")


def bound(label, nbytes, ops, kind):
    """The least time the card could take for work of ``nbytes`` moved and
    ``ops`` operations of type ``kind``: (ms, "bytes" or "operations"),
    printed on a line of its own."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    say(f"{label} bound: {nbytes} bytes -> {t_bytes} ms, {ops} {kind} ops "
        f"-> {t_ops} ms: {max(t_bytes, t_ops)} ms, bound by {by}")
    return max(t_bytes, t_ops), by


def kernel_entry(name, err, ms, plain_ms, bound_ms_by, library_ms=None,
                 **extra):
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms_by[0],
            "bound_by": bound_ms_by[1], "library_ms": library_ms, **extra}


def product_only(label, fn):
    """CUDA-event time of a library product alone (not the same function as
    the kernel, which also scores and pools): printed, not reported."""
    timing(f"{label} product only (best of 3)", cuda_ms(fn), "ms")


def max_abs_err(got, want):
    got, want = got.to(torch.float32), want.to(torch.float32)
    fin = torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def phase_decode():
    """pq_decode_recon_t vs plain on the card; returns the kernels entry.
    The wide case reads a column slice of a wider code matrix, as the
    chunked adc_fast scan does."""
    from vector_db_torch.ops import kernels as kn

    g = torch.Generator(device=DEVICE).manual_seed(5)
    worst = 0.0
    for s, sd in DECODE_SHAPES:
        for k in DECODE_SHAPES_K:
            for n in DECODE_SHAPES_N:
                wide = torch.randint(0, k, (s, 2 * n), device=DEVICE,
                                     generator=g, dtype=torch.uint8)
                codes = wide[:, n // 2:n // 2 + n]
                cbt = torch.randn(s * sd, k, device=DEVICE, generator=g)
                got = kn.pq_decode_recon_t(codes, cbt)
                want = kn.pq_decode_recon_t_plain(codes, cbt)
                torch.cuda.synchronize()
                same = torch.equal(got, want)
                err = max_abs_err(got, want)
                say(f"phase 3b decode: S={s} sd={sd} K={k} N={n} "
                    f"out={tuple(got.shape)} bit_equal={same} "
                    f"max_abs_err={err}")
                if not same:
                    raise RuntimeError("pq_decode_recon_t disagrees with its "
                                       f"plain version at S={s} K={k} N={n}")
                worst = max(worst, err)
    n = DECODE_SHAPES_N[-1]
    codes = torch.randint(0, 256, (64, 2 * n), device=DEVICE, generator=g,
                          dtype=torch.uint8)[:, :n]
    cbt = torch.randn(512, 256, device=DEVICE, generator=g)
    ms, plain_ms = timed_pair(
        "phase 3b pq_decode_recon_t", "S=64 sd=8 K=256 N=524288",
        lambda: kn.pq_decode_recon_t(codes, cbt),
        lambda: kn.pq_decode_recon_t_plain(codes, cbt))
    b = bound("phase 3b pq_decode_recon_t", 64 * n + 512 * 256 * 4
              + 512 * n * 2, 0, "bf16")  # a gather: no arithmetic
    del codes, cbt
    torch.cuda.empty_cache()
    return kernel_entry("pq_decode_recon_t", worst, ms, plain_ms, b)


def phase_packed():
    """fused_packed_pool vs plain on the card over a compressed store's
    packed rows and scan conditioning; returns the kernels entry."""
    from vector_db_torch.index.hnsw_pq import _build_scan8p_shadow
    from vector_db_torch.ops import kernels as kn
    from vector_db_torch.ops.distance import pack_int8_rows

    g = torch.Generator(device=DEVICE).manual_seed(9)
    scale = spectrum()
    stores = {}
    for n in PACKED_SHAPES_N:
        rows = torch.randn(n, DIM, device=DEVICE, generator=g) * scale
        valid = torch.rand(n, device=DEVICE, generator=g) > 0.05  # dead
        packed, scales = pack_int8_rows(rows)
        off, sc, cvec = _build_scan8p_shadow(
            packed, scales, (rows * rows).sum(1), valid, "l2")
        stores[n] = (packed, off, sc, cvec)
        del rows
    queries = torch.randn(NQ, DIM, device=DEVICE, generator=g) * scale
    worst = 0.0
    for n, (packed, off, sc, cvec) in stores.items():
        qc = queries - cvec[None, :]
        for qn in KERNEL_SHAPES_Q:
            for w in PACKED_SHAPES_W:
                worst = max(worst, hold_s8_pool(
                    f"phase 3c packed: Q={qn} N={n} d={DIM} w={w}",
                    kn.fused_packed_pool(qc[:qn], packed, off, sc, w),
                    kn.fused_packed_pool_plain(qc[:qn], packed, off, sc, w)))
    packed, off, sc, cvec = stores[PACKED_SHAPES_N[0]]
    cut = PACKED_SHAPES_N[0] - 128
    try:
        kn.fused_packed_pool(queries[:4], packed[:cut], off[:cut], sc[:cut],
                             2048)
    except ValueError as e:
        say(f"phase 3c packed: N={cut}, w=2048 raises ValueError: {e}")
    else:
        raise RuntimeError("fused_packed_pool accepted N % w != 0")
    packed, off, sc, cvec = stores[PACKED_SHAPES_N[-1]]
    qc = queries - cvec[None, :]
    ms, plain_ms = timed_pair(
        "phase 3c fused_packed_pool", "Q=1024 N=1001472 d=512 w=2048",
        lambda: kn.fused_packed_pool(qc, packed, off, sc, 2048),
        lambda: kn.fused_packed_pool_plain(qc, packed, off, sc, 2048))
    n = packed.shape[0]
    q1_ms = q1_time("phase 3c fused_packed_pool", f"N={n} d={DIM} w=2048",
                    lambda: kn.fused_packed_pool(qc[:1], packed, off, sc,
                                                 2048))
    b = bound("phase 3c fused_packed_pool", n * DIM + 8 * n + 4 * NQ * DIM
              + 8 * NQ * 2048, 2 * NQ * n * DIM, "int8")
    del stores, packed, off, sc
    torch.cuda.empty_cache()
    return kernel_entry("fused_packed_pool", worst, ms, plain_ms, b,
                        q1_ms=q1_ms)


def timed_pair(label, shape, kernel, plain):
    """CUDA-event times of a kernel and its plain version (best of 3 each,
    plain, kernel, plain); prints both lines and returns (ms, plain_ms)."""
    plain_ms = cuda_ms(plain)
    ms = cuda_ms(kernel)
    plain_ms = min(plain_ms, cuda_ms(plain))
    timing(f"{label} kernel {shape} (best of 3)", ms, "ms")
    timing(f"{label} plain  {shape} (best of 3)", plain_ms, "ms")
    return ms, plain_ms


def corpus_1m(seed):
    """The 1M store's shape (capacity 1,000,064 rows) of seeded gaussian
    rows with ~5% dead slots, and seeded queries."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    big = -(-N_KERNEL // 128) * 128  # 1,000,064
    corpus = torch.randn(big, DIM, device=DEVICE, generator=g)
    valid = torch.rand(big, device=DEVICE, generator=g) > 0.05  # dead rows
    queries = torch.randn(NQ, DIM, device=DEVICE, generator=g)
    return corpus, (corpus * corpus).sum(1), valid, queries


def phase_int8g():
    """3d: fused_int8g_pool (B7) vs plain over the global-scale shadow of
    the 1M store's shape, bit-equal required; returns the kernels entry."""
    from vector_db_torch.index.hnsw_pq import (SHADOW_PAD_ROWS,
                                               _build_scan8g_shadow)
    from vector_db_torch.ops import kernels as kn

    corpus, norms, valid, queries = corpus_1m(11)
    base8, off, sv, sgn, cvec, _ = _build_scan8g_shadow(
        corpus, norms, valid, "l2", SHADOW_PAD_ROWS)
    del corpus, norms, valid
    n = base8.shape[0]
    qc = queries - cvec[None, :]
    worst = 0.0
    for qn in KERNEL_SHAPES_Q:
        for w in KERNEL_SHAPES_W:
            worst = max(worst, hold_s8_pool(
                f"phase 3d int8g: Q={qn} N={n} d={DIM} w={w}",
                kn.fused_int8g_pool(qc[:qn], base8, off, sv, sgn, w),
                kn.fused_int8g_pool_plain(qc[:qn], base8, off, sv, sgn, w)))
    ms, plain_ms = timed_pair(
        "phase 3d fused_int8g_pool", f"Q={NQ} N={n} d={DIM} w=2048",
        lambda: kn.fused_int8g_pool(qc, base8, off, sv, sgn, 2048),
        lambda: kn.fused_int8g_pool_plain(qc, base8, off, sv, sgn, 2048))
    q1_ms = q1_time("phase 3d fused_int8g_pool", f"N={n} d={DIM} w=2048",
                    lambda: kn.fused_int8g_pool(qc[:1], base8, off, sv, sgn,
                                                2048))
    b = bound("phase 3d fused_int8g_pool", n * DIM + 4 * n + 4 * NQ * DIM
              + 8 * NQ * 2048, 2 * NQ * n * DIM, "int8")
    del base8, off
    torch.cuda.empty_cache()
    return kernel_entry("fused_int8g_pool", worst, ms, plain_ms, b,
                        q1_ms=q1_ms)


def hold_float_pool(label, got, want, terms, w):
    """check_float_pool of a bf16 pool kernel; prints its line, raises when
    the kernel leaves the bound."""
    from vector_db_torch.ops import kernels as kn

    torch.cuda.synchronize()
    res = kn.check_float_pool(got, want, terms, w)
    say(f"{label} pool={tuple(got[0].shape)} "
        f"slot_agreement={res['slot_agreement']} "
        f"max_abs_err={res['max_abs_err']} within_bound={res['ok']} "
        f"live_slots={int((got[1] >= 0).sum())}")
    if not res["ok"]:
        raise RuntimeError(f"{label}: the kernel leaves the f32 "
                           "summation-order bound of its plain version")
    return res["max_abs_err"]


def phase_raw():
    """3e: fused_raw_pool (B6) vs plain over the bf16 shadow of the 1M
    store's shape, within the summation-order bound; returns the kernels
    entry."""
    from vector_db_torch.index.hnsw_pq import (SHADOW_PAD_ROWS,
                                               _build_scan16_shadow)
    from vector_db_torch.ops import kernels as kn

    corpus, norms, valid, queries = corpus_1m(13)
    base16, off, sc, cvec, _ = _build_scan16_shadow(
        corpus, norms, valid, "l2", SHADOW_PAD_ROWS)
    del corpus, norms, valid
    n = base16.shape[0]
    qc = queries - cvec[None, :]
    worst = 0.0
    for qn in KERNEL_SHAPES_Q:
        for w in KERNEL_SHAPES_W:
            q = qc[:qn]
            worst = max(worst, hold_float_pool(
                f"phase 3e raw: Q={qn} N={n} d={DIM} w={w}",
                kn.fused_raw_pool(q, base16, off, sc, w),
                kn.fused_raw_pool_plain(q, base16, off, sc, w),
                lambda s, q=q: kn.raw_pool_terms(q, base16, off, sc, s),
                kn.pool_width(w)))
    ms, plain_ms = timed_pair(
        "phase 3e fused_raw_pool", f"Q={NQ} N={n} d={DIM} w=2048",
        lambda: kn.fused_raw_pool(qc, base16, off, sc, 2048),
        lambda: kn.fused_raw_pool_plain(qc, base16, off, sc, 2048))
    q1_ms = q1_time("phase 3e fused_raw_pool", f"N={n} d={DIM} w=2048",
                    lambda: kn.fused_raw_pool(qc[:1], base16, off, sc, 2048))
    split_sweep("phase 3e fused_raw_pool", (1024, 129, 1), (1, 2, 4, 8, 16),
                lambda qn: kn.fused_raw_pool(qc[:qn], base16, off, sc, 2048))
    b = bound("phase 3e fused_raw_pool", 2 * n * DIM + 8 * n + 4 * NQ * DIM
              + 8 * NQ * 2048, 2 * NQ * n * DIM, "bf16")
    q16 = qc.to(torch.bfloat16)
    product_only(f"phase 3e bf16 torch.mm [1024, 512] x [512, {n}]",
                 lambda: torch.mm(q16, base16.T))
    del base16, off, sc, q16
    torch.cuda.empty_cache()
    worst = max(worst, ragged_raw())
    return kernel_entry("fused_raw_pool", worst, ms, plain_ms, b,
                        q1_ms=q1_ms)


def split_sweep(label, qns, splits, run):
    """Kernel time at forced pass-split counts beside the plan's own
    (ops/kernels.pool_splits), printed: the measurement behind the pools'
    split plan.  Below Q=1024 in windows of 10 calls (:func:`per_call_ms`);
    at Q=1024 one call a window, since ten calls in a row of the bf16 pool
    ran up to 11% slower on an H100 at 700 W as the run went on."""
    from vector_db_torch.ops import kernels as kn

    plan = kn.pool_splits
    try:
        for qn in qns:
            calls = 1 if qn >= NQ else 10
            times = {"plan": per_call_ms(lambda: run(qn), calls)}
            for sp in splits:
                kn.pool_splits = lambda *a, sp=sp: sp
                times[sp] = per_call_ms(lambda: run(qn), calls)
            kn.pool_splits = plan
            timing(f"{label} Q={qn} ms by pass splits (best of 3 windows "
                   f"of {calls} calls)", json.dumps(times), "")
    finally:
        kn.pool_splits = plan


def ragged_raw():
    """3e: fused_raw_pool at the ragged shapes (Q past a 128-query tile, d
    not a multiple of the 64-dim k-chunk, N not a multiple of the pool
    width, the widest rows the tiles take); returns the largest error."""
    from vector_db_torch.index.hnsw_pq import _build_scan16_shadow
    from vector_db_torch.ops import kernels as kn

    g = torch.Generator(device=DEVICE).manual_seed(29)
    worst = 0.0
    for d in RAGGED_RAW_D:
        rows = torch.randn(RAGGED_N, d, device=DEVICE, generator=g) + 0.5
        valid = torch.rand(RAGGED_N, device=DEVICE, generator=g) > 0.05
        base16, off, sc, cvec, _ = _build_scan16_shadow(
            rows, (rows * rows).sum(1), valid, "l2", 1)
        queries = torch.randn(max(RAGGED_Q), d, device=DEVICE, generator=g)
        for qn in RAGGED_Q:
            q = queries[:qn] - cvec[None, :]
            worst = max(worst, hold_float_pool(
                f"phase 3e raw ragged: Q={qn} N={RAGGED_N} d={d} w=300",
                kn.fused_raw_pool(q, base16, off, sc, 300),
                kn.fused_raw_pool_plain(q, base16, off, sc, 300),
                lambda s, q=q: kn.raw_pool_terms(q, base16, off, sc, s),
                kn.pool_width(300)))
    return worst


def phase_adc():
    """3f: fused_adc_pool (B5) vs plain, S=64, sd=8, on a column slice of a
    wider code matrix (as the chunked adc_fast scan reads it), pool width
    ceil(N / 32); returns the kernels entry."""
    from vector_db_torch.ops import kernels as kn

    g = torch.Generator(device=DEVICE).manual_seed(17)
    s, sd = DECODE_SHAPES[0]
    queries = torch.randn(NQ, s * sd, device=DEVICE, generator=g)
    worst = 0.0
    cases = {}
    for k in ADC_SHAPES_K:
        cbt = torch.randn(s * sd, k, device=DEVICE, generator=g) * 0.3
        for n in ADC_SHAPES_N:
            wide = torch.randint(0, k, (s, 2 * n), device=DEVICE,
                                 generator=g, dtype=torch.uint8)
            codes = wide[:, n // 2:n // 2 + n]
            norms = kn.pq_decode_recon_t_plain(codes, cbt).to(
                torch.float32).square().sum(0)
            norms[torch.rand(n, device=DEVICE, generator=g) < 0.05] = \
                float("inf")
            w = -(-n // ADC_BUCKET)
            for qn in ADC_SHAPES_Q:
                q = queries[:qn]
                worst = max(worst, hold_float_pool(
                    f"phase 3f adc: Q={qn} S={s} sd={sd} K={k} N={n} w={w}",
                    kn.fused_adc_pool(q, codes, cbt, norms, w),
                    kn.fused_adc_pool_plain(q, codes, cbt, norms, w),
                    lambda sl, q=q, codes=codes, cbt=cbt, norms=norms:
                        kn.adc_pool_terms(q, codes, cbt, norms, sl),
                    kn.pool_width(w)))
            cases[(k, n)] = (codes, cbt, norms, w)
    codes, cbt, norms, w = cases[(256, ADC_SHAPES_N[-1])]
    ms, plain_ms = timed_pair(
        "phase 3f fused_adc_pool",
        f"Q={NQ} S={s} sd={sd} K=256 N={ADC_SHAPES_N[-1]} w={w}",
        lambda: kn.fused_adc_pool(queries, codes, cbt, norms, w),
        lambda: kn.fused_adc_pool_plain(queries, codes, cbt, norms, w))
    n = ADC_SHAPES_N[-1]
    q1_ms = q1_time("phase 3f fused_adc_pool", f"S={s} sd={sd} K=256 N={n} "
                    f"w={w}", lambda: kn.fused_adc_pool(queries[:1], codes,
                                                        cbt, norms, w))
    split_sweep("phase 3f fused_adc_pool", (1024, 1), (1, 2, 4),
                lambda qn: kn.fused_adc_pool(queries[:qn], codes, cbt, norms,
                                             w))
    b = bound("phase 3f fused_adc_pool", s * n + s * sd * 256 * 4 + 4 * n
              + 4 * NQ * s * sd + 8 * NQ * kn.pool_width(w),
              2 * NQ * n * s * sd, "bf16")
    q16 = queries.to(torch.bfloat16)
    recon = kn.pq_decode_recon_t_plain(codes, cbt)
    product_only(f"phase 3f bf16 torch.mm [1024, {s * sd}] x [{s * sd}, {n}]",
                 lambda: torch.mm(q16, recon))
    del cases, codes, cbt, norms, q16, recon
    torch.cuda.empty_cache()
    worst = max(worst, ragged_adc())
    return kernel_entry("fused_adc_pool", worst, ms, plain_ms, b,
                        q1_ms=q1_ms)


def ragged_adc():
    """3f: fused_adc_pool at the ragged shapes: each (S, sd) of RAGGED_ADC
    (entries that are not one 16-byte vector, d not a multiple of 64, the
    widest rows), K=200, N not a multiple of the pool width, on a column
    slice that starts at an odd column (byte code loads) and on an aligned
    one; returns the largest error."""
    from vector_db_torch.ops import kernels as kn

    g = torch.Generator(device=DEVICE).manual_seed(31)
    worst = 0.0
    k, n, w = 200, RAGGED_N, 300
    for s, sd in RAGGED_ADC:
        cbt = torch.randn(s * sd, k, device=DEVICE, generator=g) * 0.3
        wide = torch.randint(0, k, (s, 2 * n + 64), device=DEVICE,
                             generator=g, dtype=torch.uint8)
        queries = torch.randn(max(RAGGED_Q), s * sd, device=DEVICE,
                              generator=g)
        for start in (1, 64):
            codes = wide[:, start:start + n]
            norms = kn.pq_decode_recon_t_plain(codes, cbt).to(
                torch.float32).square().sum(0)
            norms[torch.rand(n, device=DEVICE, generator=g) < 0.05] = \
                float("inf")
            for qn in RAGGED_Q:
                q = queries[:qn]
                worst = max(worst, hold_float_pool(
                    f"phase 3f adc ragged: Q={qn} S={s} sd={sd} K={k} N={n} "
                    f"w={w} start={start}",
                    kn.fused_adc_pool(q, codes, cbt, norms, w),
                    kn.fused_adc_pool_plain(q, codes, cbt, norms, w),
                    lambda sl, q=q, codes=codes, norms=norms:
                        kn.adc_pool_terms(q, codes, cbt, norms, sl),
                    kn.pool_width(w)))
    return worst


def spectrum():
    """The spectral corpus' per-dim scale (i + 1)^-0.5 (bench.py's
    memory-bound corpus, benchmarks/bench_10m_api.py)."""
    return (torch.arange(DIM, device=DEVICE, dtype=torch.float32) + 1) ** -0.5


def reset_launches():
    from vector_db_torch.ops import kernels as kn

    for name in KERNELS:
        getattr(kn, name).launches = 0


def read_launches(label, must_launch=(), must_not=()):
    """Launch counts of the path just driven; raises if a kernel of the
    path never launched (or one that must not did)."""
    from vector_db_torch.ops import kernels as kn

    counts = {name: getattr(kn, name).launches for name in KERNELS}
    say(f"phase {label}: kernel launches {json.dumps(counts)}")
    for name in must_launch:
        if counts[name] == 0:
            raise RuntimeError(f"{label}: the path never launched {name}")
    for name in must_not:
        if counts[name] != 0:
            raise RuntimeError(f"{label}: the path launched {name}")
    return counts



def make_db(n, path=None, cfg=None, metric="l2", hnsw=False, dim=DIM,
            flush_interval=None):
    """An HNSWPQ database (``cfg``: HnswPqConfig fields), or with ``hnsw``
    an IndexType.HNSW one (``cfg``: HnswConfig fields).  ``flush_interval``
    (mutations between two checkpoints, 1,000 by default) is an argument of
    VectorDatabase itself; the fluent chain does not take it."""
    from vector_db_torch import (HnswConfig, HnswPqConfig, IndexType,
                                 VectorDatabase)

    config = HnswConfig(**(cfg or {})) if hnsw else HnswPqConfig(**(cfg or CFG))
    if flush_interval is not None:
        return VectorDatabase(
            dim, n, IndexType.HNSW if hnsw else IndexType.HNSWPQ, metric,
            path, index_config=config, flush_interval=flush_interval,
            device=DEVICE)
    b = (VectorDatabase.builder().with_dimension(dim).with_max_elements(n)
         .with_index_type(IndexType.HNSW if hnsw else IndexType.HNSWPQ)
         .with_metric(metric).with_index_config(config).with_device(DEVICE))
    if path:
        b = b.with_storage_path(path)
    return b.build()


def exact_ids(corpus, queries):
    from vector_db_torch.ops.distance import blocked_knn

    valid = torch.ones(corpus.shape[0], dtype=torch.bool, device=DEVICE)
    _, idx = blocked_knn(queries, corpus, valid, K, block_n=131072)
    return idx.cpu().tolist()  # ids are the row numbers


def serve(db, label, queries, gt, q1_reps=20):
    """Recall, batched QPS and Q=1 latency (median of ``q1_reps`` single
    queries) of db; returns the ids."""
    if db.index.kind == "hnsw":
        cfg_mode = mode = "hnsw"
    else:
        cfg_mode = db.index.config.search_mode
        mode = db.index.resolve_mode(db.size())
    ids = result_ids(db.search_batch(queries, K))
    rec = recall(ids, gt)
    say(f"phase {label}: rows={db.size()} {cfg_mode} -> "
        f"{mode} recall@10={rec}")
    t = host_s(lambda: db.search_batch(queries, K))
    timing(f"phase {label} batched QPS (Q={NQ}, k={K}, best of 3)",
           NQ / t, "queries/s")
    lat = sorted(host_s(lambda: db.search_batch(queries[i:i + 1], K), reps=1)
                 for i in range(q1_reps))
    timing(f"phase {label} Q=1 latency (median of {q1_reps})",
           lat[q1_reps // 2] * 1e3, "ms")
    return mode, rec, ids


def phase_100k():
    n = N_FLAGSHIP
    path = os.path.join(WORK, "db100k")
    shutil.rmtree(path, ignore_errors=True)
    corpus = torch.randn(n, DIM, device=DEVICE,
                         generator=torch.Generator(device=DEVICE).manual_seed(42))
    queries = torch.randn(NQ, DIM, device=DEVICE,
                          generator=torch.Generator(device=DEVICE).manual_seed(7))
    gt = exact_ids(corpus, queries)
    reset_launches()
    db = make_db(n, path)
    t0 = time.perf_counter()
    db.add_batch(range(n), corpus)
    torch.cuda.synchronize()
    timing("phase 4 100k build (add_batch + WAL + train + encode)",
           time.perf_counter() - t0, "s")
    mode, rec, ids = serve(db, "4 100k", queries, gt)
    if mode != "scan_exact":
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
    return read_launches("4 100k", must_not=tuple(KERNELS))


PHASE5_MODES = (  # (mode, int8_epilogue, must launch, must not launch)
    ("scan_pallas", "per_row", ("fused_raw_pool",),
     ("fused_int8_pool", "fused_int8g_pool")),
    ("scan_pallas_int8", "global", ("fused_int8g_pool",),
     ("fused_int8_pool",)),
    ("scan_bf16", "per_row", (), POOL_KERNELS),
)


def crud_round(db, label, modes):
    """Add a far vector, find it, delete it, and miss it, in each of
    ``modes`` ((search_mode, int8_epilogue) pairs, set on db.index.config);
    raises unless every step holds."""
    vid = 10**8
    far = torch.full((DIM,), 3.0, device=DEVICE) * spectrum()
    if not db.add_vector(vid, far):
        raise RuntimeError(f"{label} CRUD: add_vector refused")
    got = db.get_vector(vid)
    err = float(np.abs(got.values - far.cpu().numpy()).max())
    hits, gone = {}, {}
    for mode, epi in modes:
        db.index.config.search_mode, db.index.config.int8_epilogue = mode, epi
        hits[f"{mode}/{epi}"] = db.search(far, K)[0].id == vid
    if not db.delete_vector(vid):
        raise RuntimeError(f"{label} CRUD: delete_vector failed")
    for mode, epi in modes:
        db.index.config.search_mode, db.index.config.int8_epilogue = mode, epi
        gone[f"{mode}/{epi}"] = vid not in [r.id for r in db.search(far, K)]
    say(f"phase {label} CRUD: add ok, get max_abs_err={err}, hit={hits}, "
        f"gone after delete={gone}, rows={db.size()}")
    if not (all(hits.values()) and all(gone.values()) and err < 1e-3):
        raise RuntimeError(f"{label} CRUD failed")


def phase_1m():
    """The raw store at 1M: auto -> scan_pallas_int8, then scan_pallas,
    scan_pallas_int8 with the global epilogue and scan_bf16 on the same
    database, and CRUD in the two new kernel modes; returns the launch
    counts of its paths."""
    n = N_KERNEL
    torch.cuda.reset_peak_memory_stats()
    corpus = torch.randn(n, DIM, device=DEVICE,
                         generator=torch.Generator(device=DEVICE).manual_seed(42))
    queries = torch.randn(NQ, DIM, device=DEVICE,
                          generator=torch.Generator(device=DEVICE).manual_seed(7))
    gt = exact_ids(corpus, queries)
    reset_launches()
    db = make_db(n)
    t0 = time.perf_counter()
    db.bulk_load(range(n), corpus)
    torch.cuda.synchronize()
    timing("phase 5 1M build (bulk_load + train + encode)",
           time.perf_counter() - t0, "s")
    mode, rec, _ = serve(db, "5 1M", queries, gt)
    index_time("5 1M auto scan_pallas_int8", db.index, queries)
    counts = read_launches("5 1M", must_launch=("fused_int8_pool",),
                           must_not=("fused_int8g_pool", "fused_raw_pool"))
    if mode != "scan_pallas_int8":
        raise RuntimeError(f"1M: auto resolved to {mode}")
    if rec < 0.95:
        raise RuntimeError(f"1M recall@10 {rec} < 0.95")
    timing("phase 5 1M peak device memory",
           torch.cuda.max_memory_allocated() / 2**30, "GiB")

    def add(c):
        for name in counts:
            counts[name] += c[name]

    for mode, epi, must, must_not in PHASE5_MODES:
        db.index.config.search_mode, db.index.config.int8_epilogue = mode, epi
        label = f"5 1M {mode}" + (" global" if epi == "global" else "")
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        _, rec, _ = serve(db, label, queries, gt)
        if must:  # a pool kernel's mode
            index_time(label, db.index, queries)
        add(read_launches(label, must_launch=must, must_not=must_not))
        timing(f"phase {label} peak device memory",
               torch.cuda.max_memory_allocated() / 2**30, "GiB")
        if rec < 0.95:
            raise RuntimeError(f"{label} recall@10 {rec} < 0.95")
    reset_launches()
    crud_round(db, "5 1M", (("scan_pallas", "per_row"),
                            ("scan_pallas_int8", "global")))
    add(read_launches("5 1M CRUD", must_launch=("fused_raw_pool",
                                                "fused_int8g_pool")))
    db.close()
    return counts


def stream_spectral(queries, work, n_chunks, known_gt=None):
    """A spectral corpus as bulk_load_stream chunks: chunk c is randn from a
    CUDA generator seeded 42 + c times the spectrum, ids c*131072 + i.
    Exact top-10 ground truth is merged per chunk on the way (so the f32
    corpus never exists whole), unless ``known_gt`` of an earlier stream of
    the same chunks is handed in; ``work`` accumulates the seconds spent on
    generation and ground truth."""
    from vector_db_torch.ops.distance import blocked_knn
    from vector_db_torch.ops.topk import merge_topk

    scale = spectrum()
    ones = torch.ones(N_10M_CHUNK, dtype=torch.bool, device=DEVICE)
    gt_d = torch.full((NQ, K), float("inf"), device=DEVICE)
    gt_i = torch.full((NQ, K), -1, dtype=torch.int32, device=DEVICE)
    for c in range(n_chunks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = torch.Generator(device=DEVICE).manual_seed(42 + c)
        chunk = torch.randn(N_10M_CHUNK, DIM, device=DEVICE, generator=g) * scale
        if known_gt is None:
            d, i = blocked_knn(queries, chunk, ones, K, block_n=N_10M_CHUNK)
            gt_d, gt_i = merge_topk(gt_d, gt_i, d, i + c * N_10M_CHUNK, K)
        torch.cuda.synchronize()
        work["seconds"] += time.perf_counter() - t0
        yield np.arange(c * N_10M_CHUNK, (c + 1) * N_10M_CHUNK), chunk
    work["gt"] = gt_i.cpu().tolist() if known_gt is None else known_gt


#: phase 6's exact ground truth, which phase 8c reads (the same stream)
GT_10M = {"gt": None}


def phase_10m():
    """The compressed tier at 10M through VectorDatabase; returns the
    launch counts of its paths."""
    n = N_10M_CHUNK * N_10M_CHUNKS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    queries = torch.randn(
        NQ, DIM, device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(7)) * spectrum()
    work = {"seconds": 0.0}
    reset_launches()
    db = make_db(n + 1024, cfg=CFG_10M)
    t0 = time.perf_counter()
    rows = db.bulk_load_stream(stream_spectral(queries, work, N_10M_CHUNKS))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    gt = GT_10M["gt"] = work["gt"]
    timing(f"phase 6 10M ingest (bulk_load_stream of {rows} rows: train + "
           "pack + residual + encode; generation and ground truth excluded)",
           total - work["seconds"], "s")
    timing("phase 6 10M corpus generation + ground truth (inside the stream)",
           work["seconds"], "s")
    stats = db.stats()
    say(f"phase 6 10M: rows={db.size()} capacity={stats['capacity']} "
        f"store_bytes={stats['store_bytes']} raw_bytes={stats['raw_bytes']} "
        f"index_bytes={stats['index_bytes']} wal={db._engine is not None}")
    if db.size() != n or db._engine is not None:
        raise RuntimeError("10M: wrong row count, or a WAL was opened")
    counts = {name: 0 for name in KERNELS}

    def add(c):
        for name in counts:
            counts[name] += c[name]

    add(read_launches("6 10M ingest"))
    for mode, pool, floor, kernel, other in (
            ("auto", "approx", 0.94, "pq_decode_recon_t",
             "fused_packed_pool"),
            ("scan_pallas_int8", "approx", 0.96, "fused_packed_pool",
             "pq_decode_recon_t"),
            ("adc_fast", "fused", 0.94, "fused_adc_pool",
             "fused_packed_pool")):
        db.index.config.search_mode, db.index.config.adc_pool = mode, pool
        label = f"6 10M {mode} {pool}"
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        resolved, rec, ids = serve(db, label, queries, gt)
        if mode != "auto":
            index_time(label, db.index, queries)
        add(read_launches(label, must_launch=(kernel,),
                          must_not=(other, "fused_int8_pool")))
        timing(f"phase {label} peak device memory",
               torch.cuda.max_memory_allocated() / 2**30, "GiB")
        if mode == "auto" and resolved != "adc_fast":
            raise RuntimeError(f"10M: auto resolved to {resolved}")
        if rec < floor:
            raise RuntimeError(f"{label} recall@10 {rec} < {floor}")
    db.index.config.adc_pool = "approx"
    # the proxy scan: no kernel; chunked, since [Q, N] f32 passes 6 GB
    from vector_db_torch.ops import pca as pca_ops

    db.index.config.search_mode = "pca"
    label = "6 10M pca"
    if NQ * db.index.store.capacity * 4 <= pca_ops.FULL_ROW_BYTES:
        raise RuntimeError("10M pca would not take the chunked branch")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    _, rec, _ = serve(db, label, queries, gt)
    index_time(label, db.index, queries)
    profile_search(f"{label} index.search_batch Q=1",
                   lambda: db.index.search_batch(queries[:1], K))
    add(read_launches(label, must_not=tuple(KERNELS)))
    timing(f"phase {label} peak device memory",
           torch.cuda.max_memory_allocated() / 2**30, "GiB")
    say(f"phase {label}: proxy_bytes={stats['proxy_bytes']} chunk="
        f"{db.index._scan_chunk(db.index.store.capacity, NQ)} rows "
        "(TPU reference recall@10 94.35%)")
    if rec < 0.92 or stats["proxy_bytes"] != db.index.store.capacity * 64 * 2:
        raise RuntimeError(f"{label} recall@10 {rec} < 0.92, or no proxy")
    # CRUD at 10M live, in the tier's scan kernels' modes and under pca
    reset_launches()
    crud_round(db, "6 10M", (("adc_fast", "per_row"),
                             ("scan_pallas_int8", "per_row"),
                             ("pca", "per_row")))
    add(read_launches("6 10M CRUD", must_launch=("pq_decode_recon_t",
                                                   "fused_packed_pool")))
    if db.size() != n:
        raise RuntimeError("10M CRUD changed the row count")
    db.close()
    del db
    torch.cuda.empty_cache()
    return counts


def phase_membound():
    """The raw store's memory-bound adc_fast with a bf16 refine store."""
    n = N_FLAGSHIP
    scale = spectrum()
    corpus = torch.randn(n, DIM, device=DEVICE, generator=torch.Generator(
        device=DEVICE).manual_seed(42)) * scale
    queries = torch.randn(NQ, DIM, device=DEVICE, generator=torch.Generator(
        device=DEVICE).manual_seed(7)) * scale
    gt = exact_ids(corpus, queries)
    reset_launches()
    db = make_db(n, cfg=CFG_MEMBOUND)
    t0 = time.perf_counter()
    db.bulk_load(range(n), corpus)
    torch.cuda.synchronize()
    timing("phase 7 100k memory-bound build (bulk_load + train + encode)",
           time.perf_counter() - t0, "s")
    mode, rec, _ = serve(db, "7 100k memory-bound", queries, gt)
    counts = read_launches("7 100k memory-bound",
                           must_launch=("pq_decode_recon_t",),
                           must_not=("fused_int8_pool", "fused_packed_pool",
                                     "fused_adc_pool"))
    if mode != "adc_fast" or rec < 0.96:
        raise RuntimeError(f"memory-bound: {mode} recall@10 {rec} < 0.96")
    db.index.config.adc_pool = "fused"
    reset_launches()
    _, rec_f, _ = serve(db, "7 100k memory-bound fused", queries, gt)
    fused = read_launches("7 100k memory-bound fused",
                          must_launch=("fused_adc_pool",),
                          must_not=("fused_int8_pool", "fused_packed_pool"))
    say(f"phase 7 100k memory-bound: recall@10 approx={rec} fused={rec_f}")
    if rec_f < 0.96:
        raise RuntimeError(f"memory-bound fused recall@10 {rec_f} < 0.96")
    db.close()
    return {name: c + fused[name] for name, c in counts.items()}


def read_rows(counts, p_cap):
    """The pool rows a merge reads: prober ranks below each cluster's
    count, cluster-major."""
    first = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device) * p_cap,
        counts.long())
    start = torch.repeat_interleave(torch.cumsum(counts.long(), 0)
                                    - counts.long(), counts.long())
    return first + torch.arange(first.numel(), device=counts.device) - start


def ivf_case(g, nlist, cap, p_cap, d, counts):
    """Random int8 probers and cluster rows, ~20% +inf offsets (grid pads
    and disabled rows) and negative scales, as a layout's."""
    qsel = torch.randint(-127, 128, (nlist * p_cap, d), device=DEVICE,
                         generator=g, dtype=torch.int8).view(torch.int32)
    cm = torch.randint(-127, 128, (nlist * cap, d), device=DEVICE,
                       generator=g, dtype=torch.int8).view(torch.int32)
    off = torch.randn(nlist * cap, device=DEVICE, generator=g) * 100
    off[torch.rand(nlist * cap, device=DEVICE, generator=g) < 0.2] = \
        float("inf")
    sc = -torch.rand(nlist * cap, device=DEVICE, generator=g) * 0.01
    return counts.clamp(max=p_cap).to(torch.int32), qsel, cm, off, sc


def hold_ivf(label, args, nlist, cap, p_cap, winners, canary=False):
    """fused_ivf_pool (B8) against its plain version, bit-equal on the rows
    a merge reads (read_rows), launched with and without the caller's
    count of probes; with ``canary`` into outputs filled with a sentinel,
    which every other row (rows at or past a cluster's count, the rows of
    unprobed clusters) must still hold.  Prints its line, raises on a
    difference, returns the largest error."""
    from vector_db_torch.ops import kernels as kn

    counts = args[0]
    d = 4 * args[2].shape[1]
    pv, pp = kn.fused_ivf_pool_plain(*args, nlist, cap, p_cap, winners)
    rows = read_rows(counts, p_cap)
    fin = torch.isfinite(pv[rows])
    same, kept, err = True, True, 0.0
    for probes in (None, int(counts.sum())):
        out = None
        if canary:
            out = (torch.full_like(pv, -12345.0), torch.full_like(pp, -777))
        kv, kp = kn.fused_ivf_pool(*args, nlist, cap, p_cap, winners,
                                   probes=probes, out=out)
        torch.cuda.synchronize()
        same &= (torch.equal(kv[rows], pv[rows])
                 and torch.equal(kp[rows][fin], pp[rows][fin]))
        err = max(err, max_abs_err(kv[rows], pv[rows]))
        if canary:
            other = torch.ones(kv.shape[0], dtype=torch.bool, device=DEVICE)
            other[rows] = False
            kept &= bool((kv[other] == -12345.0).all()
                         and (kp[other] == -777).all())
    say(f"{label}: nlist={nlist} cap={cap} p_cap={p_cap} d={d} "
        f"winners={winners} probed={int((counts > 0).sum())} "
        f"rows_read={rows.numel()} bit_equal={same} max_abs_err={err}"
        + (f" canary_rows={int(other.sum())} untouched={kept}" if canary
           else ""))
    if not same:
        raise RuntimeError("fused_ivf_pool disagrees with its plain version "
                           f"at cap={cap} p_cap={p_cap} winners={winners}")
    if not kept:
        raise RuntimeError("fused_ivf_pool wrote a row at or past a "
                           f"cluster's count at cap={cap} p_cap={p_cap}")
    return err


def ivf_bound(label, counts, cap, p_cap, d):
    """The bound of one fused_ivf_pool call: the probed clusters' rows and
    per-position values and the live prober rows read once, the live pool
    rows written once; the s8 products of live rows only."""
    probed = int((counts > 0).sum())
    live = int(counts.clamp(max=p_cap).sum())
    return bound(label, probed * cap * (d + 8) + live * d + 4 * counts.numel()
                 + live * 128 * 8, 2 * live * cap * d, "int8")


def phase_ivf_kernel():
    """3g: fused_ivf_pool (B8) vs plain, bit-equal on the rows the merge
    reads, at the 1M scan_ivf grid, at prober tiles that end mid-tile (with
    canary rows), at one-bucket and full-pool-row clusters and at the 10M
    grid's shape; timed at the 1M grid for Q=1024 and Q=1 and at the 10M
    grid; returns the kernels-line entry."""
    from vector_db_torch.ops import kernels as kn
    from vector_db_torch.ops.ivf_scan import auto_ivf_geometry

    g = torch.Generator(device=DEVICE).manual_seed(19)
    nlist, cap, p_cap, d = (IVF_SHAPE[k] for k in ("nlist", "cap", "p_cap",
                                                    "d"))
    # ~128 probers a cluster, 10% of clusters unprobed, a few tiles full
    counts = torch.randint(1, 256, (nlist,), device=DEVICE, generator=g)
    counts[torch.rand(nlist, device=DEVICE, generator=g) < 0.1] = 0
    counts[:4] = p_cap
    one = torch.zeros(nlist, device=DEVICE, dtype=torch.int32)
    one[torch.randperm(nlist, device=DEVICE, generator=g)[:64]] = 1
    worst = 0.0
    main = q1 = None
    for pc, winners, cnt in ((p_cap, 4, counts), (p_cap, 2, counts),
                             (p_cap, 1, counts), (32, 4, one)):
        args = ivf_case(g, nlist, cap, pc, d, cnt)
        worst = max(worst, hold_ivf("phase 3g ivf", args, nlist, cap, pc,
                                    winners))
        if main is None:
            main = args
        q1 = args
    # prober tiles that end mid-tile (a 128-row box runs into the next
    # cluster's probers at p_cap 32 and 64), with canary rows
    for pc in (32, 64):
        cnt = torch.randint(0, pc + 1, (nlist,), device=DEVICE, generator=g)
        cnt[::7] = 0
        cnt[1::7] = pc
        worst = max(worst, hold_ivf(
            "phase 3g ivf ragged", ivf_case(g, nlist, cap, pc, d, cnt), nlist,
            cap, pc, 4, canary=True))
    # one bucket a cluster; a full pool row (winners * cap / 128 = 128)
    for nl, cp, pc in ((64, 128, 64), (16, 4096, 160)):
        cnt = torch.randint(0, pc + 1, (nl,), device=DEVICE, generator=g)
        worst = max(worst, hold_ivf(
            "phase 3g ivf edge", ivf_case(g, nl, cp, pc, d, cnt), nl, cp, pc,
            4, canary=True))
    ms, plain_ms = timed_pair(
        "phase 3g fused_ivf_pool",
        f"nlist={nlist} cap={cap} p_cap={p_cap} d={d} winners=4",
        lambda: kn.fused_ivf_pool(*main, nlist, cap, p_cap, 4,
                                  probes=NQ * 64),
        lambda: kn.fused_ivf_pool_plain(*main, nlist, cap, p_cap, 4))
    b = ivf_bound("phase 3g fused_ivf_pool", counts, cap, p_cap, d)
    timing("phase 3g fused_ivf_pool ms by winners (best of 3)", json.dumps(
        {w: cuda_ms(lambda: kn.fused_ivf_pool(*main, nlist, cap, p_cap, w,
                                              probes=NQ * 64))
         for w in (1, 2, 4)}), "")
    stage_sweep("phase 3g fused_ivf_pool",
                lambda: kn.fused_ivf_pool(*main, nlist, cap, p_cap, 4,
                                          probes=NQ * 64), "IVF_POOL_STAGES")
    q1_ms = q1_time("phase 3g fused_ivf_pool",
                    f"nlist={nlist} cap={cap} p_cap=32 d={d} winners=4, 64 "
                    "clusters probed",
                    lambda: kn.fused_ivf_pool(*q1, nlist, cap, 32, 4,
                                              probes=64))
    ivf_bound("phase 3g fused_ivf_pool Q=1", one, cap, 32, d)
    ivf_split_sweep("phase 3g fused_ivf_pool Q=1", cap,
                    lambda: kn.fused_ivf_pool(*q1, nlist, cap, 32, 4,
                                              probes=64))
    del main, q1, args
    torch.cuda.empty_cache()
    # the 10M grid: the geometry and the prober tile a 9,961,472-row store
    # gets (ivf_search_shape: p_cap = pow2(4 Q nprobe / nlist) in [32, 512]),
    # ~13 probers a cluster; ~6.7 GB of rows, built here and freed
    nl, cp = auto_ivf_geometry(N_10M_CHUNK * N_10M_CHUNKS)
    pc = min(512, max(32, 1 << (4 * NQ * 64 // nl - 1).bit_length()))
    cnt = torch.poisson(torch.full((nl,), NQ * 64 / nl, device=DEVICE),
                        generator=g).long()
    big = ivf_case(g, nl, cp, pc, d, cnt)
    worst = max(worst, hold_ivf("phase 3g ivf 10M grid", big, nl, cp, pc, 4))
    timing(f"phase 3g fused_ivf_pool kernel nlist={nl} cap={cp} p_cap={pc} "
           f"d={d} winners=4 (best of 3)",
           cuda_ms(lambda: kn.fused_ivf_pool(*big, nl, cp, pc, 4,
                                             probes=NQ * 64)), "ms")
    ivf_bound("phase 3g fused_ivf_pool 10M grid", big[0], cp, pc, d)
    del big
    torch.cuda.empty_cache()
    return kernel_entry("fused_ivf_pool", worst, ms, plain_ms, b, q1_ms=q1_ms)


def ivf_split_sweep(label, cap, run, splits=(1, 2, 3, 4, 7, 21)):
    """Kernel time of the cluster scan at forced bucket splits beside
    ops/kernels.ivf_pool_plan's own, printed: the measurement behind the
    plan's split when few clusters are probed."""
    from vector_db_torch.ops import kernels as kn

    plan = kn.ivf_pool_plan
    buckets = cap // 128

    def forced(sp):
        per = -(-buckets // sp)

        def f(*a, **kw):
            return plan(*a, **kw)._replace(splits=-(-buckets // per),
                                           buckets_per_split=per)
        return f
    try:
        times = {"plan": ahead_ms(run)}
        for sp in splits:
            kn.ivf_pool_plan = forced(sp)
            times[sp] = ahead_ms(run)
    finally:
        kn.ivf_pool_plan = plan
    timing(f"{label} ms by bucket splits (the host running ahead, best of 3 "
           "windows of 20 calls)", json.dumps(times), "")


def phase_scan_topk():
    """3h: fused_scan_topk (B1) vs plain within the f32 summation-order
    bound.  No index of either package calls it, so its entry is marked
    ``no_index_caller``.  Returns the kernels-line entry."""
    from vector_db_torch.ops import kernels as kn

    g = torch.Generator(device=DEVICE).manual_seed(23)
    worst = 0.0
    data = {}
    for n in SCAN_SHAPES_N:
        base = torch.randn(n, DIM, device=DEVICE, generator=g)
        bn = (base * base).sum(1)
        bn[torch.rand(n, device=DEVICE, generator=g) < 0.05] = float("inf")
        data[n] = (base, bn)
    queries = torch.randn(NQ, DIM, device=DEVICE, generator=g)
    for n, (base, bn) in data.items():
        for qn in SCAN_SHAPES_Q:
            for winners in (1, 2):
                q = queries[:qn]
                got = kn.fused_scan_topk(q, base, bn, K, winners=winners)
                want = kn.fused_scan_topk_plain(q, base, bn, K,
                                                winners=winners)
                torch.cuda.synchronize()
                res = kn.check_scan_topk(got, want, q, base, bn)
                say(f"phase 3h scan_topk: Q={qn} N={n} d={DIM} k={K} "
                    f"winners={winners} id_agreement={res['id_agreement']} "
                    f"max_abs_err={res['max_abs_err']} "
                    f"within_bound={res['ok']}")
                if not res["ok"]:
                    raise RuntimeError("fused_scan_topk leaves the bound of "
                                       f"its plain version at Q={qn} N={n}")
                worst = max(worst, res["max_abs_err"])
    base, bn = data[SCAN_SHAPES_N[-1]]
    n = base.shape[0]
    ms, plain_ms = timed_pair(
        "phase 3h fused_scan_topk", f"Q={NQ} N={n} d={DIM} k={K} winners=1",
        lambda: kn.fused_scan_topk(queries, base, bn, K),
        lambda: kn.fused_scan_topk_plain(queries, base, bn, K))
    b = bound("phase 3h fused_scan_topk", 4 * (NQ * DIM + n * DIM + n)
              + 8 * NQ * K, 2 * NQ * n * (DIM + 1), "f32")
    product_only(f"phase 3h f32 torch.mm [1024, 512] x [512, {n}]",
                 lambda: torch.mm(queries, base.T))
    # the wrapper's count, shown on its own line: no path runs this kernel
    reset_launches()
    kn.fused_scan_topk(queries, base, bn, K)
    read_launches("3h fused_scan_topk self-test (one call, not a path)",
                  must_launch=("fused_scan_topk",))
    del data, base, bn
    torch.cuda.empty_cache()
    entry = kernel_entry("fused_scan_topk", worst, ms, plain_ms, b)
    entry["no_index_caller"] = True
    return entry


def hold_s8_pool(label, got, want):
    """Bit-equality of an s8 pool kernel with its plain version; prints its
    line, raises when they differ."""
    torch.cuda.synchronize()
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    say(f"{label} pool={tuple(got[0].shape)} bit_equal={same} "
        f"max_abs_err={max_abs_err(got[0], want[0])} "
        f"live_slots={int((got[1] >= 0).sum())}")
    if not same:
        raise RuntimeError(f"{label}: the kernel disagrees with its plain "
                           "version")
    return max_abs_err(got[0], want[0])


def phase_wide():
    """3i: the six pools at rows of any width (WIDE_D) on stores of WIDE_N
    rows, against their plain versions, each timed at Q=1024; returns the
    largest error of each."""
    from vector_db_torch.index.hnsw_pq import (_build_scan8_shadow,
                                               _build_scan8g_shadow,
                                               _build_scan16_shadow)
    from vector_db_torch.ops import kernels as kn

    g = torch.Generator(device=DEVICE).manual_seed(37)
    worst = {name: 0.0 for name in POOL_KERNELS}
    n, w = WIDE_N, 2048
    for d in WIDE_D:
        rows = torch.randn(n, d, device=DEVICE, generator=g)
        valid = torch.rand(n, device=DEVICE, generator=g) > 0.05
        norms = (rows * rows).sum(1)
        queries = torch.randn(NQ, d, device=DEVICE, generator=g)
        b8, off, sc, cvec = _build_scan8_shadow(rows, norms, valid, "l2",
                                                1)[:4]
        g8, goff, sv, sgn, gvec, _ = _build_scan8g_shadow(rows, norms, valid,
                                                          "l2", 1)
        pools = {  # name -> (kernel, plain, their call on a batch)
            "fused_int8_pool": (kn.fused_int8_pool, kn.fused_int8_pool_plain,
                                lambda f, q: f(q - cvec, b8, off, sc, w)),
            "fused_packed_pool": (
                kn.fused_packed_pool, kn.fused_packed_pool_plain,
                lambda f, q: f(q - cvec, b8.view(torch.int32), off, sc, w)),
            "fused_int8g_pool": (
                kn.fused_int8g_pool, kn.fused_int8g_pool_plain,
                lambda f, q: f(q - gvec, g8, goff, sv, sgn, w)),
        }
        for name, (kernel, plain, call) in pools.items():
            for qn in WIDE_Q:
                q = queries[:qn]
                worst[name] = max(worst[name], hold_s8_pool(
                    f"phase 3i wide {name}: Q={qn} N={n} d={d} w={w}",
                    call(kernel, q), call(plain, q)))
            wide_time(name, d, lambda: call(kernel, queries))
        del b8, g8
        if d % 16:  # the bf16 pools at 768 and 1536 dims
            continue
        b16, roff, rsc, rvec, _ = _build_scan16_shadow(rows, norms, valid,
                                                       "l2", 1)
        for qn in WIDE_Q:
            q = queries[:qn] - rvec
            worst["fused_raw_pool"] = max(worst["fused_raw_pool"],
                                          hold_float_pool(
                f"phase 3i wide fused_raw_pool: Q={qn} N={n} d={d} w={w}",
                kn.fused_raw_pool(q, b16, roff, rsc, w),
                kn.fused_raw_pool_plain(q, b16, roff, rsc, w),
                lambda sl, q=q: kn.raw_pool_terms(q, b16, roff, rsc, sl), w))
        wide_time("fused_raw_pool", d, lambda: kn.fused_raw_pool(
            queries - rvec, b16, roff, rsc, w))
        del b16
        s, sd = d // 8, 8
        codes = torch.randint(0, 256, (s, n), device=DEVICE, generator=g,
                              dtype=torch.uint8)
        cbt = torch.randn(s * sd, 256, device=DEVICE, generator=g) * 0.3
        mn = kn.pq_decode_recon_t_plain(codes, cbt).float().square().sum(0)
        mn[~valid] = float("inf")
        for qn in WIDE_Q:
            q = queries[:qn]
            worst["fused_adc_pool"] = max(worst["fused_adc_pool"],
                                          hold_float_pool(
                f"phase 3i wide fused_adc_pool: Q={qn} S={s} sd={sd} N={n} "
                f"w={w}", kn.fused_adc_pool(q, codes, cbt, mn, w),
                kn.fused_adc_pool_plain(q, codes, cbt, mn, w),
                lambda sl, q=q: kn.adc_pool_terms(q, codes, cbt, mn, sl), w))
        wide_time("fused_adc_pool", d, lambda: kn.fused_adc_pool(
            queries, codes, cbt, mn, w))
        del codes, rows
    for d in WIDE_D:
        nlist, cap, p_cap = 64, 1024, 128
        counts = torch.randint(1, p_cap + 1, (nlist,), device=DEVICE,
                               generator=g)
        counts[::5] = 0
        args = ivf_case(g, nlist, cap, p_cap, d, counts)
        worst["fused_ivf_pool"] = max(worst["fused_ivf_pool"], hold_ivf(
            "phase 3i wide fused_ivf_pool", args, nlist, cap, p_cap, 4,
            canary=True))
        ms = per_call_ms(lambda: kn.fused_ivf_pool(*args, nlist, cap, p_cap,
                                                   4), 10)
        timing(f"phase 3i wide fused_ivf_pool kernel nlist={nlist} cap={cap} "
               f"p_cap={p_cap} d={d} (best of 3 windows of 10 calls)", ms,
               "ms")
    torch.cuda.empty_cache()
    return worst


def wide_time(name, d, run, calls=10):
    timing(f"phase 3i wide {name} kernel Q={NQ} N={WIDE_N} d={d} w=2048 "
           f"(best of 3 windows of {calls} calls)", per_call_ms(run, calls),
           "ms")


def index_time(label, index, queries):
    """Index-level time of one Q=1024 search (best of 3, host clock around
    synchronised work) and one profiled search's device split."""
    timing(f"phase {label} index.search_batch time (Q={NQ}, k={K}, best of 3)",
           host_s(lambda: index.search_batch(queries, K)) * 1e3, "ms")
    profile_search(f"{label} index.search_batch Q={NQ}",
                   lambda: index.search_batch(queries, K))


def profile_search(label, fn, host_ops=True):
    """One fn() under torch.profiler after a warm-up: the device kernels
    by total time and the device's idle share of the host window.  Without
    ``host_ops`` only the device is traced: a graph search is thousands of
    launches, and tracing its host operators too takes 17 s where this
    takes 2.5 (same device time and launch count)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 if host_ops else [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # kernels only: an aten op's self device time repeats its kernels'
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    device = sum(r[0] for r in rows)
    if not rows:
        say(f"phase {label} profile: no device time in the trace "
            "(not measured)")
        return
    timing(f"phase {label} profile: wall {wall:.3f} ms, device {device:.3f} "
           f"ms in {sum(r[1] for r in rows)} launches, idle",
           1 - device / wall, "of the window")
    for ms, count, key in rows[:12]:
        say(f"phase {label} profile: {ms:.3f} ms in {count} x {key[:90]}")


def time_coarse_fit(ix):
    """Wrap the index's coarse k-means so its synchronised seconds add up
    in the returned dict's "seconds"."""
    coarse = {"seconds": 0.0}
    fit = ix._coarse_kmeans

    def timed_fit(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit(*a, **kw)
        torch.cuda.synchronize()
        coarse["seconds"] += time.perf_counter() - t0
        return out

    ix._coarse_kmeans = timed_fit
    return coarse


def phase_ivf():
    """8: scan_ivf at 1M through VectorDatabase, compressed (a) and raw
    (b); returns the launch counts of its paths."""
    n = N_10M_CHUNK * N_IVF_CHUNKS
    torch.cuda.empty_cache()
    queries = torch.randn(
        NQ, DIM, device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(7)) * spectrum()
    work = {"seconds": 0.0}
    counts = {name: 0 for name in KERNELS}

    def add(c):
        for name in counts:
            counts[name] += c[name]

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    db = make_db(n + 1024, cfg=CFG_IVF)
    ix = db.index
    coarse = time_coarse_fit(ix)
    t0 = time.perf_counter()
    rows = db.bulk_load_stream(stream_spectral(queries, work, N_IVF_CHUNKS))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    gt = work["gt"]
    timing(f"phase 8a ingest (bulk_load_stream of {rows} rows: train + "
           "coarse quantizer + pack + residual + encode; generation and "
           "ground truth excluded)", total - work["seconds"], "s")
    timing("phase 8a coarse quantizer training (inside the ingest)",
           coarse["seconds"], "s")
    t0 = time.perf_counter()
    lay = ix._ivf_layout()
    torch.cuda.synchronize()
    timing("phase 8a layout build (choices + balanced placement + gather)",
           time.perf_counter() - t0, "s")
    nprobe, p_cap, pool = ix.ivf_search_shape(NQ, 16)
    say(f"phase 8a: rows={db.size()} capacity={ix.store.capacity} "
        f"nlist={lay.centroids.shape[0]} cap={lay.cap} nprobe={nprobe} "
        f"p_cap={p_cap} pool={pool} spilled={lay.spilled} "
        f"grid_bytes={lay.cm_packed.numel() * 4}")
    add(read_launches("8a ingest"))
    reset_launches()
    _, rec, ids = serve(db, "8a scan_ivf 1M compressed", queries, gt)
    timing(f"phase 8a index QPS (Q={NQ}, k={K}, best of 3)",
           NQ / host_s(lambda: ix.search_batch(queries, K)), "queries/s")
    add(read_launches("8a scan_ivf 1M compressed",
                      must_launch=("fused_ivf_pool",),
                      must_not=POOL_KERNELS[:-1] + NO_INDEX_CALLER))
    timing("phase 8a peak device memory",
           torch.cuda.max_memory_allocated() / 2**30, "GiB")
    if rec < 0.93:
        raise RuntimeError(f"8a scan_ivf recall@10 {rec} < 0.93")
    reset_launches()
    profile_search("8a index.search_batch Q=1024",
                   lambda: ix.search_batch(queries, K))
    profile_search("8a index.search_batch Q=1",
                   lambda: ix.search_batch(queries[:1], K))
    add(read_launches("8a profiled searches", must_launch=("fused_ivf_pool",)))
    # CRUD: adds land in the exact overlay, a removal takes effect at once,
    # the overlay budget crossed lays the grid out again
    reset_launches()
    gen = torch.Generator(device=DEVICE).manual_seed(99)
    new = torch.randn(300, DIM, device=DEVICE, generator=gen) * spectrum()
    new_ids = list(range(10**8, 10**8 + 300))
    if len(db.add_batch(new_ids, new)) != 300:
        raise RuntimeError("8a CRUD: add_batch refused rows")
    found = [r[0].id if r else -1 for r in db.search_batch(new, K)]
    hit = sum(f == i for f, i in zip(found, new_ids)) / 300
    overlay = ix._caches.ivf.value.overlay.size
    victim = ids[0][0]
    if not db.delete_vector(victim):
        raise RuntimeError("8a CRUD: delete_vector failed")
    gone = victim not in result_ids(db.search_batch(queries[:1], K))[0]
    more = torch.randn(800, DIM, device=DEVICE, generator=gen) * spectrum()
    db.add_batch(range(2 * 10**8, 2 * 10**8 + 800), more)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db.search_batch(queries[:1], K)
    relayout_s = time.perf_counter() - t0
    lay = ix._caches.ivf
    drained = lay.value.overlay.size == 0 and lay.key == ix.store.version
    say(f"phase 8a CRUD: 300 adds found={hit} overlay={overlay} "
        f"removed id gone={gone} overlay after 800 more adds and a search="
        f"{lay.value.overlay.size} relayout={drained} rows={db.size()}")
    timing("phase 8a relayout search (Q=1, layout rebuilt)", relayout_s, "s")
    add(read_launches("8a CRUD", must_launch=("fused_ivf_pool",)))
    if hit < 0.99 or overlay != 300 or not gone or not drained:
        raise RuntimeError("8a scan_ivf CRUD failed")
    db.close()
    del db, ix, lay
    torch.cuda.empty_cache()

    # 8b: the raw store, the same corpus by bulk_load
    g_chunks = [torch.randn(N_10M_CHUNK, DIM, device=DEVICE,
                            generator=torch.Generator(device=DEVICE)
                            .manual_seed(42 + c)) * spectrum()
                for c in range(N_IVF_CHUNKS)]
    corpus = torch.cat(g_chunks)
    del g_chunks
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    db = make_db(n, cfg=CFG_IVF_RAW)
    t0 = time.perf_counter()
    db.bulk_load(range(n), corpus)
    torch.cuda.synchronize()
    timing("phase 8b raw build (bulk_load + train + coarse quantizer + "
           "encode)", time.perf_counter() - t0, "s")
    del corpus
    t0 = time.perf_counter()
    lay = db.index._ivf_layout()
    torch.cuda.synchronize()
    timing("phase 8b layout build", time.perf_counter() - t0, "s")
    say(f"phase 8b: rows={db.size()} nlist={lay.centroids.shape[0]} "
        f"cap={lay.cap} spilled={lay.spilled}")
    _, rec_b, _ = serve(db, "8b scan_ivf 1M raw", queries, gt)
    timing(f"phase 8b index QPS (Q={NQ}, k={K}, best of 3)",
           NQ / host_s(lambda: db.index.search_batch(queries, K)),
           "queries/s")
    profile_search("8b index.search_batch Q=1",
                   lambda: db.index.search_batch(queries[:1], K))
    add(read_launches("8b scan_ivf 1M raw", must_launch=("fused_ivf_pool",),
                      must_not=POOL_KERNELS[:-1] + NO_INDEX_CALLER))
    timing("phase 8b peak device memory",
           torch.cuda.max_memory_allocated() / 2**30, "GiB")
    if rec_b < 0.93:
        raise RuntimeError(f"8b scan_ivf raw recall@10 {rec_b} < 0.93")
    db.close()
    del db, lay
    torch.cuda.empty_cache()
    return counts


def phase_ivf_10m():
    """8c: scan_ivf at 10M through VectorDatabase on the compressed +
    residual store (its own bulk_load_stream of phase 6's corpus, with the
    coarse quantizer trained in the stream), at nprobe 64, 128 and 256,
    and again with the coarse quantizer retrained on a sample of the whole
    store; returns the launch counts of its paths.  No reference figure
    exists at this size, so recall has no floor of its own: it must rise
    with nprobe."""
    n = N_10M_CHUNK * N_10M_CHUNKS
    torch.cuda.empty_cache()
    queries = torch.randn(
        NQ, DIM, device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(7)) * spectrum()
    work = {"seconds": 0.0}
    counts = {name: 0 for name in KERNELS}

    def add(c):
        for name in counts:
            counts[name] += c[name]

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    db = make_db(n + 1024, cfg=CFG_IVF)
    ix = db.index
    coarse = time_coarse_fit(ix)
    t0 = time.perf_counter()
    rows = db.bulk_load_stream(stream_spectral(queries, work, N_10M_CHUNKS,
                                               known_gt=GT_10M["gt"]))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    gt = work["gt"]
    timing(f"phase 8c ingest (bulk_load_stream of {rows} rows: train + "
           "coarse quantizer + pack + residual + encode; generation "
           "excluded)", total - work["seconds"], "s")
    timing("phase 8c coarse quantizer training (inside the ingest)",
           coarse["seconds"], "s")
    t0 = time.perf_counter()
    lay = ix._ivf_layout()
    torch.cuda.synchronize()
    timing("phase 8c layout build (choices + balanced placement + gather)",
           time.perf_counter() - t0, "s")
    nprobe, p_cap, pool = ix.ivf_search_shape(NQ, 16)
    say(f"phase 8c: rows={db.size()} capacity={ix.store.capacity} "
        f"nlist={lay.centroids.shape[0]} cap={lay.cap} nprobe={nprobe} "
        f"p_cap={p_cap} (Q=1: {ix.ivf_search_shape(1, 16)[1]}) pool={pool} "
        f"spilled={lay.spilled} grid_bytes={lay.cm_packed.numel() * 4}")
    add(read_launches("8c ingest"))
    recalls = {}
    for probes in (64, 128, 256):
        ix.config.nprobe = probes
        label = f"8c scan_ivf 10M nprobe={probes}"
        reset_launches()
        if probes == 64:
            _, rec, _ = serve(db, label, queries, gt)
            index_time(label, ix, queries)
            profile_search(f"{label} index.search_batch Q=1",
                           lambda: ix.search_batch(queries[:1], K))
        else:
            rec = recall(result_ids(db.search_batch(queries, K)), gt)
            say(f"phase {label}: p_cap={ix.ivf_search_shape(NQ, 16)[1]} "
                f"recall@10={rec}")
            timing(f"phase {label} index.search_batch time (Q={NQ}, k={K}, "
                   "best of 3)",
                   host_s(lambda: ix.search_batch(queries, K)) * 1e3, "ms")
        recalls[probes] = rec
        add(read_launches(label, must_launch=("fused_ivf_pool",),
                          must_not=POOL_KERNELS[:-1] + NO_INDEX_CALLER))
    timing("phase 8c peak device memory",
           torch.cuda.max_memory_allocated() / 2**30, "GiB")
    say(f"phase 8c: recall@10 by nprobe {json.dumps(recalls)}")
    if not recalls[64] <= recalls[128] <= recalls[256] \
            or recalls[256] <= recalls[64]:
        raise RuntimeError(f"8c scan_ivf recall@10 does not rise with "
                           f"nprobe: {recalls}")
    # what the streamed quantizer costs: the stream trains it on its first
    # chunk; train() would take max(256 nlist, 262144) live rows, as here
    nlist = ix.coarse_centroids.shape[0]
    live = np.flatnonzero(ix.store.state.valid.cpu().numpy())
    pick = np.sort(np.random.default_rng(ix.seed + 7).choice(
        live, min(live.size, max(256 * nlist, 262144)), replace=False))
    reset_launches()
    t0 = time.perf_counter()
    ix._set_coarse(ix._coarse_kmeans(ix.store.rows(pick), nlist))
    lay = ix._ivf_layout()
    torch.cuda.synchronize()
    timing(f"phase 8c coarse quantizer retrained on {pick.size} sampled rows "
           "+ layout", time.perf_counter() - t0, "s")
    again = {}
    for probes in (64, 256):
        ix.config.nprobe = probes
        again[probes] = recall(result_ids(db.search_batch(queries, K)), gt)
    ix.config.nprobe = 64
    timing(f"phase 8c retrained index.search_batch time (Q={NQ}, k={K}, "
           "best of 3)", host_s(lambda: ix.search_batch(queries, K)) * 1e3,
           "ms")
    say(f"phase 8c retrained: spilled={lay.spilled} recall@10 by nprobe "
        f"{json.dumps(again)}")
    add(read_launches("8c retrained", must_launch=("fused_ivf_pool",),
                      must_not=POOL_KERNELS[:-1] + NO_INDEX_CALLER))
    db.close()
    del db, ix, lay
    torch.cuda.empty_cache()
    return counts


def gaussian(n, dim, seed):
    return torch.randn(n, dim, device=DEVICE,
                       generator=torch.Generator(device=DEVICE).manual_seed(seed))


def hold_floor(label, rec, floor, note=""):
    say(f"phase {label}: recall@10={rec} floor={floor}{note}")
    if rec < floor:
        raise RuntimeError(f"{label} recall@10 {rec} < {floor}")


def search_time(label, index, queries):
    timing(f"phase {label} index.search_batch time (Q={NQ}, k={K}, best of "
           "3)", host_s(lambda: index.search_batch(queries, K)) * 1e3, "ms")


def profile_both(label, index, queries, host_ops=True):
    """Index time at Q=1024, and one profiled search at Q=1024 and Q=1."""
    search_time(label, index, queries)
    for qn in (NQ, 1):
        profile_search(f"{label} index.search_batch Q={qn}",
                       lambda: index.search_batch(queries[:qn], K), host_ops)


def phase_adc_modes():
    """9a: search_mode="adc" on the memory-bound 100k corpus, exhaustive and
    cluster-pruned, on both stores; then adc_decode_topk against
    adc_scan_topk on the index's own codes.  Returns the launch counts."""
    from vector_db_torch.ops import adc

    n = N_FLAGSHIP
    scale = spectrum()
    corpus = gaussian(n, DIM, 42) * scale
    queries = gaussian(NQ, DIM, 7) * scale
    gt = exact_ids(corpus, queries)
    counts = {name: 0 for name in KERNELS}
    raw_ix = None
    for store in ("raw", "int8_resid"):
        for nlist in (0, 1024):
            cfg = dict(CFG_ADC, nlist=nlist)
            if store != "raw":
                cfg.update(raw_store=False, refine_residual=True)
            label = f"9a adc 100k {store} nlist={nlist}"
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            db = make_db(n, cfg=cfg)
            t0 = time.perf_counter()
            if store == "raw":
                db.bulk_load(range(n), corpus)
            else:
                db.bulk_load_stream(
                    (np.arange(s, min(s + 32768, n)), corpus[s:s + 32768])
                    for s in range(0, n, 32768))
            torch.cuda.synchronize()
            timing(f"phase {label} build", time.perf_counter() - t0, "s")
            mode, rec, _ = serve(db, label, queries, gt)
            if store == "raw":  # the compressed store differs by its refine
                profile_both(label, db.index, queries)
            else:
                search_time(label, db.index, queries)
            timing(f"phase {label} peak device memory",
                   torch.cuda.max_memory_allocated() / 2**30, "GiB")
            if nlist:
                members, max_len, over = db.index._member_table()
                say(f"phase {label}: member table {tuple(members.shape)} "
                    f"overflow={int((over >= 0).sum())} candidates a query="
                    f"{64 * max_len + over.shape[0]}")
            for name, c in read_launches(label, must_not=tuple(KERNELS)).items():
                counts[name] += c
            if mode != "adc":
                raise RuntimeError(f"{label}: resolved to {mode}")
            # the same index under phase 7's adc_fast settings, for scale
            cfg_ix = db.index.config
            cfg_ix.search_mode, cfg_ix.adc_pool = "adc_fast", "approx"
            cfg_ix.adc_select_r = 128
            reset_launches()
            fast = recall(result_ids(db.search_batch(queries, K)), gt)
            for name, c in read_launches(
                    f"{label} as adc_fast", must_launch=("pq_decode_recon_t",),
                    must_not=POOL_KERNELS).items():
                counts[name] += c
            cfg_ix.search_mode = "adc"
            hold_floor(label, rec, ADC_FLOORS[(store, nlist)],
                       " (measured less 0.01); the same index's adc_fast "
                       f"(approx pool, select 128) recall@10={fast}")
            if store == "raw" and nlist == 0:
                raw_ix = db.index
            else:
                db.close()
    # the ranked ADC scan through the decode kernel against the table scan
    ix = raw_ix
    st = ix.store.state
    ct, cbt, cnorms = ix._fast_tables()
    tables = adc.build_distance_tables(queries[:, ix.perm], ix.codebooks)
    reset_launches()
    scan_d, scan_i = adc.adc_scan_topk(tables, ix.codes, st.valid, 128,
                                       impl="gather")
    dec_d, dec_i = adc.adc_decode_topk(queries, ct, cbt, st.valid, 128,
                                       code_norms=cnorms, perm=ix.perm)
    rel = float(((dec_d - scan_d).abs() / scan_d.clamp(min=1e-6)).max())
    same = float((dec_i[:, :, None] == scan_i[:, None, :]).any(2)
                 .float().mean())
    say(f"phase 9a adc_decode_topk vs adc_scan_topk (Q={NQ}, k=128, N="
        f"{st.capacity}): max relative distance error={rel} (bar 2e-2, bf16 "
        f"rounding) shared slots={same}")
    timing("phase 9a adc_decode_topk", cuda_ms(lambda: adc.adc_decode_topk(
        queries, ct, cbt, st.valid, 128, code_norms=cnorms, perm=ix.perm)),
        "ms")
    timing("phase 9a adc_scan_topk gather", cuda_ms(lambda: adc.adc_scan_topk(
        tables, ix.codes, st.valid, 128, impl="gather")), "ms")
    timing("phase 9a adc_scan_topk onehot", cuda_ms(lambda: adc.adc_scan_topk(
        tables, ix.codes, st.valid, 128, impl="onehot")), "ms")
    for name, c in read_launches("9a adc_decode_topk",
                                 must_launch=("pq_decode_recon_t",),
                                 must_not=POOL_KERNELS).items():
        counts[name] += c
    if rel > 2e-2 or same < 0.9:
        raise RuntimeError("9a: adc_decode_topk disagrees with adc_scan_topk")
    return counts


def phase_pca():
    """9b: search_mode="pca" on the memory-bound 100k corpus, pca_r 128 and
    256 under L2 and 256 under cosine.  Returns the launch counts."""
    from vector_db_torch.ops.distance import normalize_rows

    n = N_FLAGSHIP
    scale = spectrum()
    corpus = gaussian(n, DIM, 42) * scale
    queries = gaussian(NQ, DIM, 7) * scale
    counts = {name: 0 for name in KERNELS}
    for metric in ("l2", "cosine"):
        gt = exact_ids(normalize_rows(corpus), normalize_rows(queries)) \
            if metric == "cosine" else exact_ids(corpus, queries)
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        db = make_db(n, cfg=dict(CFG_PCA, pca_r=256), metric=metric)
        t0 = time.perf_counter()
        db.bulk_load(range(n), corpus)
        torch.cuda.synchronize()
        timing(f"phase 9b pca 100k {metric} build (bulk_load + train + proxy "
               "fit + encode + project)", time.perf_counter() - t0, "s")
        say(f"phase 9b pca 100k {metric}: proxy_bytes="
            f"{db.stats()['proxy_bytes']} index_bytes="
            f"{db.stats()['index_bytes']}")
        for r in (128, 256) if metric == "l2" else (256,):
            db.index.config.pca_r = r
            label = f"9b pca 100k {metric} pca_r={r}"
            mode, rec, _ = serve(db, label, queries, gt)
            profile_both(label, db.index, queries)
            hold_floor(label, rec, PCA_FLOORS[(metric, r)],
                       " (TPU reference 97.35% / 98.22% at 128 / 256, L2)")
            if mode != "pca":
                raise RuntimeError(f"{label}: resolved to {mode}")
        timing(f"phase 9b pca 100k {metric} peak device memory",
               torch.cuda.max_memory_allocated() / 2**30, "GiB")
        for name, c in read_launches(f"9b pca {metric}",
                                     must_not=tuple(KERNELS)).items():
            counts[name] += c
        db.close()
    return counts


def timed_calls(obj, name):
    """Wrap obj.name so its synchronised seconds add up in the returned
    dict's "seconds"."""
    spent = {"seconds": 0.0, "calls": 0}
    fn = getattr(obj, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        spent["seconds"] += time.perf_counter() - t0
        spent["calls"] += 1
        return out

    setattr(obj, name, timed)
    return spent


def found_by_own_vector(db, ids, rows):
    """Share of ``ids`` that a search by their own row returns first."""
    hit = 0
    for s in range(0, len(ids), NQ):
        got = db.index.search_batch(rows[s:s + NQ], 1)[0][:, 0]
        hit += int((got == np.asarray(ids[s:s + NQ])).sum())
    return hit / len(ids)


def graph_small():
    """9c (i): IndexType.HNSW at 128-d x 10,000, ef_search 128 and 400."""
    n, dim = N_HNSW_SMALL, DIM_HNSW_SMALL
    corpus, queries = gaussian(n, dim, 42), gaussian(NQ, dim, 7)
    gt = exact_ids(corpus, queries)
    db = make_db(n, cfg=dict(ef_search=128), hnsw=True, dim=dim)
    t0 = time.perf_counter()
    db.add_batch(range(n), corpus)
    torch.cuda.synchronize()
    timing(f"phase 9c(i) HNSW {dim}-d x {n} build (add_batch + bulk_build)",
           time.perf_counter() - t0, "s")
    for ef, floor in ((128, 0.90), (400, 0.97)):
        db.index.config.ef_search = ef
        label = f"9c(i) HNSW {dim}-d x {n} ef={ef}"
        _, rec, _ = serve(db, label, queries, gt, q1_reps=5)
        if ef == 400:  # one profiled pair a graph path
            profile_both(label, db.index, queries, host_ops=False)
        else:
            search_time(label, db.index, queries)
        hold_floor(label, rec, floor,
                   " (TPU reference 93.1% / 98.8% at ef 128 / 400)")
    db.close()


def graph_incremental():
    """9c (ii): IndexType.HNSW at 512-d x 100,000: bulk build, deferred
    adds, the flush, the entry point deleted, close + reopen.  The database
    checkpoints only when it closes (flush_interval past the run's
    mutations): a checkpoint connects the pending rows first, and the
    default of one every 1,000 mutations would turn every tenth add_batch
    into a flush plus a 225 MB file."""
    n, extra = N_FLAGSHIP, N_HNSW_ADDS
    path = os.path.join(WORK, "hnsw100k")
    shutil.rmtree(path, ignore_errors=True)
    corpus, queries = gaussian(n + extra, DIM, 42), gaussian(NQ, DIM, 7)
    torch.cuda.reset_peak_memory_stats()
    db = make_db(n + extra, path, hnsw=True, flush_interval=10**9)
    ix = db.index
    build = timed_calls(ix, "_graph_insert")
    t0 = time.perf_counter()
    db.add_batch(range(n), corpus[:n])
    torch.cuda.synchronize()
    timing(f"phase 9c(ii) HNSW {DIM}-d x {n} from scratch (add_batch + WAL + "
           "bulk_build)", time.perf_counter() - t0, "s")
    timing("phase 9c(ii) bulk_build alone", build["seconds"], "s")
    st = ix.stats()
    say(f"phase 9c(ii): levels={st['level_histogram']} avg_degree_l0="
        f"{st['avg_degree_l0']} entry={st['entry_point']} max_level="
        f"{st['max_level']} ef={ix.config.ef_for_query(16, n, DIM)}")
    label = f"9c(ii) HNSW {DIM}-d x {n}"
    rec0 = recall(result_ids(db.search_batch(queries, K)),
                  exact_ids(corpus[:n], queries))
    # deferred adds: buffered, answered through the exact overlay
    new_ids = list(range(n, n + extra))
    lats = []
    for s in range(0, extra, 100):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        db.add_batch(new_ids[s:s + 100], corpus[n + s:n + s + 100])
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t0)
    pending = ix.stats()["pending_inserts"]
    before = found_by_own_vector(db, new_ids, corpus[n:])
    gt = exact_ids(corpus, queries)
    rec_pending = recall(result_ids(db.search_batch(queries, K)), gt)
    search_time(f"{label} + {extra} pending", ix, queries)
    t0 = time.perf_counter()
    ix.flush_pending()
    torch.cuda.synchronize()
    flush = time.perf_counter() - t0
    after = found_by_own_vector(db, new_ids, corpus[n:])
    lat_ms = np.asarray(lats) * 1e3
    timing(f"phase 9c(ii) {extra} adds in batches of 100 (defer): amortised "
           "with the flush", (sum(lats) + flush) / extra * 1e3, "ms/row")
    timing("phase 9c(ii) add_batch p50", float(np.percentile(lat_ms, 50)), "ms")
    timing("phase 9c(ii) add_batch p99", float(np.percentile(lat_ms, 99)), "ms")
    timing(f"phase 9c(ii) flush of {pending} pending rows "
           "(bulk_insert_delta)", flush, "s")
    say(f"phase 9c(ii): pending before the flush={pending} found by own "
        f"vector before={before} (bar 1.0: the exact overlay) after={after} "
        f"(bar {OWN_VECTOR_FLOOR}: the graph's own top-1 recall, measured "
        "less 0.01)")
    _, rec, ids = serve(db, f"{label} + {extra} flushed", queries, gt,
                        q1_reps=5)
    profile_both(f"{label} + {extra} flushed", ix, queries, host_ops=False)
    timing("phase 9c(ii) peak device memory",
           torch.cuda.max_memory_allocated() / 2**30, "GiB")
    hold_floor(f"{label} built", rec0, 0.85)
    hold_floor(f"{label} pending", rec_pending, 0.85)
    hold_floor(f"{label} flushed", rec, 0.85, " (TPU reference 89.3%)")
    if pending != extra or before < 1.0 or after < OWN_VECTOR_FLOOR:
        raise RuntimeError("9c(ii): added rows not found by their own vector")
    # the entry point goes; the answers stay valid
    entry_id = int(ix.store.state.ids[ix.graph.entry])
    if not db.delete_vector(entry_id):
        raise RuntimeError("9c(ii): delete of the entry point failed")
    ids = result_ids(db.search_batch(queries, K))
    rec_del = recall(ids, [[i for i in row if i != entry_id] for row in gt])
    live = all(0 <= i < n + extra and i != entry_id for row in ids for i in row)
    say(f"phase 9c(ii): entry point id {entry_id} deleted, new entry slot "
        f"{ix.graph.entry} level {ix.graph.entry_level}, answers valid={live} "
        f"recall@10={rec_del}")
    if not live or ix.graph.entry < 0 or rec_del < 0.85 * 0.9:
        raise RuntimeError("9c(ii): answers after deleting the entry point")
    t0 = time.perf_counter()
    db.close()
    db = make_db(n + extra, path, hnsw=True, flush_interval=10**9)
    timing("phase 9c(ii) close + reopen", time.perf_counter() - t0, "s")
    again = result_ids(db.search_batch(queries, K))
    say(f"phase 9c(ii): reopened rows={db.size()} identical_ids={again == ids}")
    if again != ids:
        raise RuntimeError("9c(ii): ids differ after close/reopen")
    db.close()
    shutil.rmtree(path, ignore_errors=True)


def graph_pq():
    """9c (iii): HnswPqIndex with its graph on the flagship 100k: ADC
    traversal + exact re-rank, adds through the pending overlay."""
    n = N_FLAGSHIP
    corpus, queries = gaussian(n + 2000, DIM, 42), gaussian(NQ, DIM, 7)
    gt = exact_ids(corpus[:n], queries)
    torch.cuda.reset_peak_memory_stats()
    db = make_db(n + 2000, cfg=CFG_GRAPH_PQ)
    t0 = time.perf_counter()
    db.bulk_load(range(n), corpus[:n])
    torch.cuda.synchronize()
    timing("phase 9c(iii) HNSWPQ graph 100k build (bulk_load + train + encode "
           "+ bulk_build)", time.perf_counter() - t0, "s")
    s = db.stats()
    say(f"phase 9c(iii): use_graph={s['use_graph']} index_bytes="
        f"{s['index_bytes']} (graph {db.index.graph.neighbors.numel() * 4})")
    for ef in (64, 256):
        db.index.config.ef_search = ef
        label = f"9c(iii) HNSWPQ graph 100k ef={ef}"
        mode, rec, _ = serve(db, label, queries, gt, q1_reps=5)
        if ef == 256:
            profile_both(label, db.index, queries, host_ops=False)
        else:
            search_time(label, db.index, queries)
        hold_floor(label, rec, GRAPH_PQ_FLOORS[ef], " (measured less 0.01)")
        if mode != "graph":
            raise RuntimeError(f"{label}: resolved to {mode}")
    new_ids = list(range(n, n + 2000))
    db.add_batch(new_ids, corpus[n:])
    pending = db.stats()["pending_inserts"]
    found = found_by_own_vector(db, new_ids, corpus[n:])
    rec = recall(result_ids(db.search_batch(queries, K)),
                 exact_ids(corpus, queries))
    search_time("9c(iii) HNSWPQ graph 100k + 2000 pending", db.index,
                     queries)
    say(f"phase 9c(iii): 2000 adds pending={pending} found by own vector="
        f"{found} recall@10={rec}")
    timing("phase 9c(iii) peak device memory",
           torch.cuda.max_memory_allocated() / 2**30, "GiB")
    if pending != 2000 or found < 1.0 or rec < GRAPH_PQ_FLOORS[256]:
        raise RuntimeError("9c(iii): pending rows not answered")
    db.close()


def graph_stream():
    """9c (iv): the sequential insert path carrying a whole build."""
    n, dim = N_STREAM, DIM_HNSW_SMALL
    corpus, queries = gaussian(n, dim, 42), gaussian(NQ, dim, 7)
    gt = exact_ids(corpus, queries)
    recs = {}
    for policy, cfg in (("bulk", {}), ("stream", dict(insert_policy="stream",
                                                      bulk_build=False))):
        db = make_db(n, cfg=cfg, hnsw=True, dim=dim)
        t0 = time.perf_counter()
        db.add_batch(range(n), corpus)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        timing(f"phase 9c(iv) HNSW {dim}-d x {n} {policy} build", took, "s")
        if policy == "stream":
            timing("phase 9c(iv) sequential insert (host_insert_stream, "
                   "rounds of 64, efc 400)", took / n * 1e3, "ms/row")
        recs[policy] = recall(result_ids(db.search_batch(queries, K)), gt)
        db.close()
    hold_floor("9c(iv) sequential insert", recs["stream"],
               recs["bulk"] - 0.02, " (the bulk-built graph's less 0.02)")


def phase_graph():
    """9c: the graph engine through VectorDatabase.  No kernel of the port
    is on these paths; returns their (zero) launch counts."""
    reset_launches()
    for part in (graph_small, graph_incremental, graph_pq, graph_stream):
        t0 = time.perf_counter()
        part()
        timing(f"phase 9c {part.__name__} took", time.perf_counter() - t0, "s")
    torch.cuda.empty_cache()
    return read_launches("9c graph", must_not=tuple(KERNELS))


def np_gaussian(n, dim, seed, spectral=False):
    """Gaussian rows from a numpy generator (full_bench.py's corpora: rows
    seed 42 and queries 7 at 512-d, 1 and 2 at 128-d; ``spectral`` scales
    dim i by (i + 1)^-0.5), on the card."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, dim), dtype=np.float32)).to(DEVICE)
    if spectral:
        x *= (torch.arange(dim, device=DEVICE, dtype=torch.float32) + 1
              ) ** -0.5
    return x


def index_corpus(n, dim, spectral=False):
    """(rows, queries [NQ_INDEX], exact top-10 ids) of a phase 10 cell."""
    seeds = (42, 7) if dim == DIM else (1, 2)
    rows = np_gaussian(n, dim, seeds[0], spectral)
    queries = np_gaussian(NQ_INDEX, dim, seeds[1], spectral)
    return rows, queries, exact_ids(rows, queries)


def loaded(index, rows):
    """``index`` with ``rows`` bulk-loaded into its store and built
    (full_bench.py's order); prints the synchronised build seconds."""
    index.store.bulk_load(range(rows.shape[0]), rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.build()
    torch.cuda.synchronize()
    return index, time.perf_counter() - t0


def index_cell(label, index, queries, gt, floor_key=None, note=""):
    """Recall@10 of one Q=NQ_INDEX batch (held to its floor), the index
    time (best of 3) and the Q=1 time (median of 20)."""
    ids, _ = index.search_batch(queries, K)
    rec = recall(ids.tolist(), gt)
    if floor_key:
        floor, tpu = INDEX_FLOORS[floor_key]
        hold_floor(label, rec, floor, f" (TPU reference {tpu}){note}")
    else:
        say(f"phase {label}: recall@10={rec}{note}")
    timing(f"phase {label} index.search_batch time (Q={NQ_INDEX}, k={K}, "
           "best of 3)", host_s(lambda: index.search_batch(queries, K)) * 1e3,
           "ms")
    lat = sorted(host_s(lambda: index.search_batch(queries[i:i + 1], K),
                        reps=1) for i in range(20))
    timing(f"phase {label} Q=1 index time (median of 20)", lat[10] * 1e3,
           "ms")
    return rec


def peak(label):
    timing(f"phase {label} peak device memory",
           torch.cuda.max_memory_allocated() / 2**30, "GiB")


def phase_pq():
    """10a: flat PQ (full_bench.py:134-145) at 512-d x 10,000 with
    refine_k 512 and 0, then at 100,000 rows and Q=1024; B3 held bit-equal
    at N=100,000 and adc_decode_topk against adc_scan_topk.  Returns the
    launch counts."""
    from vector_db_torch.api.config import PqConfig
    from vector_db_torch.index.pq import PqIndex
    from vector_db_torch.ops import adc
    from vector_db_torch.ops import kernels as kn

    counts = {name: 0 for name in KERNELS}
    rows, queries, gt = index_corpus(N_INDEX_SMALL, DIM)
    reset_launches()
    ix, took = loaded(PqIndex(DIM, N_INDEX_SMALL, "l2", PqConfig(**CFG_PQ),
                              device=DEVICE), rows)
    timing(f"phase 10a pq {DIM}-d x {N_INDEX_SMALL} train+encode", took, "s")
    index_cell("10a pq 10k refine 512", ix, queries, gt, "pq")
    ix.config.refine_k = 0
    index_cell("10a pq 10k pure ADC", ix, queries, gt,
               note=" (TPU reference 0.220)")
    for name, c in read_launches("10a pq 10k",
                                 must_launch=("pq_decode_recon_t",),
                                 must_not=POOL_KERNELS).items():
        counts[name] += c
    del ix, rows
    n = N_INDEX
    rows = np_gaussian(n, DIM, 42)
    queries = np_gaussian(NQ, DIM, 7)
    gt = exact_ids(rows, queries)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ix, took = loaded(PqIndex(DIM, n, "l2", PqConfig(**CFG_PQ),
                              device=DEVICE), rows)
    timing(f"phase 10a pq {DIM}-d x {n} train+encode", took, "s")
    ids, _ = ix.search_batch(queries, K)
    say(f"phase 10a pq 100k refine 512: recall@10={recall(ids.tolist(), gt)} "
        f"(Q={NQ}; no reference figure at this size)")
    timing(f"phase 10a pq 100k index.search_batch time (Q={NQ}, k={K}, best "
           "of 3)", host_s(lambda: ix.search_batch(queries, K)) * 1e3, "ms")
    lat = sorted(host_s(lambda: ix.search_batch(queries[i:i + 1], K), reps=1)
                 for i in range(20))
    timing("phase 10a pq 100k Q=1 index time (median of 20)", lat[10] * 1e3,
           "ms")
    profile_search(f"10a pq 100k index.search_batch Q={NQ}",
                   lambda: ix.search_batch(queries, K))
    peak("10a pq 100k")
    got = read_launches("10a pq 100k", must_launch=("pq_decode_recon_t",),
                        must_not=POOL_KERNELS)
    say(f"phase 10a pq 100k: pq_decode_recon_t launches on this path "
        f"{got['pq_decode_recon_t']}")
    for name, c in got.items():
        counts[name] += c
    # the kernel against its plain version at the index's N (not counted)
    ct, cbt, cnorms = ix._fast_tables()
    codes_t = ct[:, :n]
    same = torch.equal(kn.pq_decode_recon_t(codes_t, cbt),
                       kn.pq_decode_recon_t_plain(codes_t, cbt))
    say(f"phase 10a pq_decode_recon_t at S=64, sd=8, K=256, N={n}: "
        f"bit-equal to the plain version: {same}")
    st = ix.store.state
    q = queries[:NQ_INDEX]
    tables = adc.build_distance_tables(q[:, ix.perm], ix.codebooks)
    scan_d, scan_i = adc.adc_scan_topk(tables, ix.codes, st.valid, 128)
    dec_d, dec_i = adc.adc_decode_topk(q, ct, cbt, st.valid, 128,
                                       code_norms=cnorms, perm=ix.perm)
    rel = float(((dec_d - scan_d).abs() / scan_d.clamp(min=1e-6)).max())
    shared = float((dec_i[:, :, None] == scan_i[:, None, :]).any(2)
                   .float().mean())
    say(f"phase 10a adc_decode_topk vs adc_scan_topk (Q={NQ_INDEX}, k=128, "
        f"N={st.capacity}): max relative distance error={rel} (bar 2e-2) "
        f"shared slots={shared}")
    if not same or rel > 2e-2 or shared < 0.9:
        raise RuntimeError("10a: the decode path disagrees")
    return counts


def phase_ivf_index():
    """10b: IndexType.IVF at 128-d x 10,000 (full_bench.py:116-132, the
    nprobe sweep) and 512-d x 100,000 under the default config, Q=256 and
    Q=1.  Returns the (zero) launch counts."""
    from vector_db_torch.api.config import IvfConfig
    from vector_db_torch.index.ivf import IvfIndex

    reset_launches()
    rows, queries, gt = index_corpus(N_INDEX_SMALL, DIM_HNSW_SMALL)
    ix, took = loaded(IvfIndex(DIM_HNSW_SMALL, N_INDEX_SMALL, "l2",
                               IvfConfig(num_clusters=100, num_probes=10),
                               device=DEVICE), rows)
    timing("phase 10b ivf 128-d x 10k train", took, "s")
    tpu = {5: 0.729, 10: 0.920, 20: 0.988, 50: 0.995}
    for nprobe in IVF_NPROBES:
        ix.config.num_probes = nprobe
        index_cell(f"10b ivf 128-d x 10k nprobe={nprobe}", ix, queries, gt,
                   "ivf" if nprobe == 10 else None,
                   "" if nprobe == 10 else f" (TPU reference {tpu[nprobe]})")
    del ix
    rows, queries, gt = index_corpus(N_INDEX, DIM)
    torch.cuda.reset_peak_memory_stats()
    ix, took = loaded(IvfIndex(DIM, N_INDEX, "l2", IvfConfig(),
                               device=DEVICE), rows)
    timing("phase 10b ivf 512-d x 100k default config train", took, "s")
    members, max_len, over = ix._member_table()
    nprobe = ix.config.num_probes
    say(f"phase 10b ivf 512-d x 100k: {members.shape[0]} clusters, member "
        f"table {tuple(members.shape)}, overflow {int((over >= 0).sum())}, "
        f"candidate slots a query {nprobe * max_len + over.shape[0]}")
    index_cell("10b ivf 512-d x 100k", ix, queries, gt,
               note=" (no reference figure)")
    for qn in (NQ_INDEX, 1):
        profile_search(f"10b ivf 512-d x 100k index.search_batch Q={qn}",
                       lambda: ix.search_batch(queries[:qn], K))
    peak("10b ivf 512-d x 100k")
    return read_launches("10b ivf", must_not=tuple(KERNELS))


def phase_lsh():
    """10c: IndexType.LSH with LshConfig(backfill=False)
    (full_bench.py:197-242): 512-d x 100,000 isotropic, 128-d x 10,000,
    512-d x 100,000 spectral.  Returns the (zero) launch counts."""
    from vector_db_torch.api.config import LshConfig
    from vector_db_torch.index.lsh import LshIndex

    reset_launches()
    for key, n, dim, spectral in (("lsh 512 iso", N_INDEX, DIM, False),
                                  ("lsh 128", N_INDEX_SMALL, DIM_HNSW_SMALL,
                                   False),
                                  ("lsh 512 spectral", N_INDEX, DIM, True)):
        label = f"10c {key}"
        rows, queries, gt = index_corpus(n, dim, spectral)
        torch.cuda.reset_peak_memory_stats()
        ix, took = loaded(LshIndex(dim, n, "l2", LshConfig(backfill=False),
                                   device=DEVICE), rows)
        timing(f"phase {label} build", took, "s")
        index_cell(label, ix, queries, gt, key)
        st = ix.stats()
        say(f"phase {label}: calibrated tables={st['num_tables']} "
            f"bits={st['num_bits']} radius={st['hamming_radius']}; short "
            f"rows (backfill off) {st['backfill_rows']} in "
            f"{st['backfill_queries']} queries")
        profile_search(f"{label} index.search_batch Q={NQ_INDEX}",
                       lambda: ix.search_batch(queries, K))
        peak(label)
        del ix, rows
    return read_launches("10c lsh", must_not=tuple(KERNELS))


def phase_annoy():
    """10d: IndexType.ANNOY (full_bench.py:285-311): 128-d x 10,000 with
    backfill off and on, 512-d x 100,000 with backfill off.  Returns the
    (zero) launch counts."""
    from vector_db_torch.api.config import AnnoyConfig
    from vector_db_torch.index import annoy

    reset_launches()
    for key, n, dim in (("annoy 128", N_INDEX_SMALL, DIM_HNSW_SMALL),
                        ("annoy 512", N_INDEX, DIM)):
        label = f"10d {key}"
        rows, queries, gt = index_corpus(n, dim)
        torch.cuda.reset_peak_memory_stats()
        ix, took = loaded(annoy.AnnoyIndex(dim, n, "l2",
                                           AnnoyConfig(backfill=False),
                                           device=DEVICE), rows)
        timing(f"phase {label} host build ({ix.config.num_trees} trees, "
               f"max depth {ix._max_depth})", took, "s")
        index_cell(label, ix, queries, gt, key)
        beam = ix.beam()
        chunk = annoy.descend_rows(ix.config.num_trees, beam, dim)
        # NQ_INDEX is a power of two: the batch has no pad rows
        timing(f"phase {label} descent (Q={NQ_INDEX}, beam {beam}, "
               f"{-(-NQ_INDEX // chunk)} chunks of {chunk} queries, best "
               "of 3)", cuda_ms(lambda: ix.candidates(queries)), "ms")
        cand = ix.candidates(queries)
        distinct = torch.sort(cand, dim=1)[0]
        distinct = ((distinct[:, 1:] != distinct[:, :-1]) &
                    (distinct[:, 1:] >= 0)).sum(1).float().mean()
        say(f"phase {label}: candidate slots a query {cand.shape[1]}, "
            f"distinct rows a query {float(distinct)}")
        profile_search(f"{label} index.search_batch Q={NQ_INDEX}",
                       lambda: ix.search_batch(queries, K))
        peak(label)
        if key == "annoy 128":
            ix.config.backfill = True
            rec = recall(ix.search_batch(queries, K)[0].tolist(), gt)
            say(f"phase {label} backfill on: recall@10={rec}")
        del ix, rows, cand
    return read_launches("10d annoy", must_not=tuple(KERNELS))


def phase_facade_types():
    """10e: the four types through VectorDatabase with a storage path
    (add, delete, search, close, reopen: the same ids), then the
    text-search example at its default sizes.  Returns the launch
    counts."""
    from vector_db_torch import (AnnoyConfig, IndexType, IvfConfig,
                                 LshConfig, PqConfig, VectorDatabase)
    from vector_db_torch.examples import text_search_example

    counts = {name: 0 for name in KERNELS}
    configs = {"pq": PqConfig(num_subspaces=16), "ivf": IvfConfig(),
               "lsh": LshConfig(), "annoy": AnnoyConfig()}
    rows, queries, _ = index_corpus(N_INDEX_SMALL, DIM_HNSW_SMALL)
    for kind, cfg in configs.items():
        label = f"10e facade {kind}"
        path = os.path.join(WORK, f"facade_{kind}")
        shutil.rmtree(path, ignore_errors=True)
        reset_launches()

        def open_db():
            return (VectorDatabase.builder().with_dimension(DIM_HNSW_SMALL)
                    .with_max_elements(N_INDEX_SMALL)
                    .with_index_type(IndexType(kind))
                    .with_index_config(cfg)
                    .with_storage_path(path).with_device(DEVICE).build())
        t0 = time.perf_counter()
        db = open_db()
        db.add_batch(range(N_INDEX_SMALL - 1000), rows[:-1000])
        db.rebuild_index()
        db.add_batch(range(N_INDEX_SMALL - 1000, N_INDEX_SMALL), rows[-1000:])
        for vid in range(0, N_INDEX_SMALL, 7):
            db.delete_vector(vid)
        before = result_ids(db.search_batch(queries, K))
        if any(i % 7 == 0 for row in before for i in row):
            raise RuntimeError(f"{label}: a deleted id was returned")
        db.close()
        db = open_db()
        after = result_ids(db.search_batch(queries, K))
        size = db.size()
        db.close()
        timing(f"phase {label} add, delete, search, close, reopen",
               time.perf_counter() - t0, "s")
        say(f"phase {label}: {size} rows after the reopen, ids identical: "
            f"{after == before}")
        if after != before or size != N_INDEX_SMALL - -(-N_INDEX_SMALL // 7):
            raise RuntimeError(f"{label}: the reopened database differs")
        for name, c in read_launches(
                label, must_launch=("pq_decode_recon_t",) if kind == "pq"
                else (), must_not=POOL_KERNELS).items():
            counts[name] += c
    reset_launches()
    t0 = time.perf_counter()
    table = text_search_example.main(["--device", DEVICE])
    timing("phase 10e text_search_example.main() (1536-d x 1000 phrases, "
           "100 queries, seven types)", time.perf_counter() - t0, "s")
    for row in table:
        say(f"phase 10e example {row['index']}: top1={row['top1']} "
            f"top5={row['top5']} search {row['search_ms']} ms/query")
    if len(table) != 7 or table[0]["top5"] < 0.9:
        raise RuntimeError("10e: the example's exact scan lost its targets")
    for name, c in read_launches("10e example",
                                 must_launch=("pq_decode_recon_t",),
                                 must_not=POOL_KERNELS).items():
        counts[name] += c
    return counts


def phase_indexes():
    """10: PQ, IVF, LSH and Annoy; returns the launch counts."""
    counts = {name: 0 for name in KERNELS}
    t_start = time.perf_counter()
    for part in (phase_pq, phase_ivf_index, phase_lsh, phase_annoy,
                 phase_facade_types):
        t0 = time.perf_counter()
        for name, c in part().items():
            counts[name] += c
        torch.cuda.empty_cache()
        timing(f"phase 10 {part.__name__} took", time.perf_counter() - t0, "s")
    timing("phase 10 took", time.perf_counter() - t_start, "s")
    return counts



# ------------------------------------------------------------ phase 11
#: 11a: the raw tier at 2^20 rows; 11b: the Compressed 10M corpus of phase 6
N_SHARDED = 1 << 20
SHARDED_10M_CHUNKS = N_10M_CHUNKS
#: recall@10 floors: the single-chip floors at the same sizes (exact, raw
#: fused, compressed + residual fused); flagship and pca have no reference
#: figure at these sizes: what this script measured on an H100 less 0.01
SHARDED_FLOORS = {"exact": 0.99, "raw fused": 0.95, "compressed fused": 0.96,
                  "raw flagship": 0.6070, "raw pca": 0.0538,
                  "compressed flagship": 0.9898, "compressed pca": 0.9890}


def sharded_cell(label, search, queries, gt, floor_key):
    """Recall@10 of one Q=NQ batch through ``search`` (a ShardedDatabase
    method), held to its floor; the host wall of the call (best of 3), the
    Q=1 time (median of 10) and one profiled call's device split."""
    ids = search(queries, K)[0]
    hold_floor(label, recall(ids.tolist(), gt), SHARDED_FLOORS[floor_key])
    timing(f"phase {label} index time (Q={NQ}, k={K}, host wall, best of 3)",
           host_s(lambda: search(queries, K)) * 1e3, "ms")
    lat = sorted(host_s(lambda: search(queries[i:i + 1], K), reps=1)
                 for i in range(10))
    timing(f"phase {label} Q=1 time (median of 10)", lat[5] * 1e3, "ms")
    profile_search(f"{label} Q={NQ}", lambda: search(queries, K))
    return ids


def host_rss_gib():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def timed_host(label, fn):
    """fn() with its synchronised seconds and the host's resident set
    before it and at its peak (sampled every 10 ms by a thread)."""
    import threading

    before = peak_rss = host_rss_gib()
    stop = threading.Event()

    def sample():
        nonlocal peak_rss
        while not stop.wait(0.01):
            peak_rss = max(peak_rss, host_rss_gib())
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        stop.set()
        sampler.join()
    timing(f"phase {label} seconds", time.perf_counter() - t0, "s")
    timing(f"phase {label} host RSS peak (sampled every 10 ms; "
           f"{before} GiB before)", peak_rss, "GiB")
    return out


def sharded_raw(counts):
    """11a: the raw tier at 2^20 x 512 on a mesh of one shard (fused: B2;
    int8_epilogue="global": B7; train_pq + search_flagship: B3; fit_pca +
    search_pca; a CRUD round), then on four logical shards of the card
    (exact, held to the single-chip exact top-10; search_fused: B2 four
    times a call)."""
    from vector_db_torch.ops.distance import blocked_knn
    from vector_db_torch.parallel import sharded as sh

    n = N_SHARDED
    gen = torch.Generator(device=DEVICE)
    corpus = torch.randn(n, DIM, device=DEVICE, generator=gen.manual_seed(42))
    queries = torch.randn(NQ, DIM, device=DEVICE,
                          generator=gen.manual_seed(7))
    ones = torch.ones(n, dtype=torch.bool, device=DEVICE)
    gt_d, gt_i = blocked_knn(queries, corpus, ones, K, block_n=131072)
    gt = gt_i.cpu().tolist()
    mesh1 = sh.make_mesh(devices=[DEVICE])

    def add(c):
        for name in counts:
            counts[name] += c[name]

    def ingest(mesh, capacity, **kw):
        db = sh.ShardedDatabase(mesh, dim=DIM, capacity=capacity,
                                num_subspaces=64, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        db.add_batch(np.arange(n), corpus)
        torch.cuda.synchronize()
        return db, time.perf_counter() - t0

    def fused_db(epi, kernel):
        label = f"11a raw mesh1 {epi}"
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        db, took = ingest(mesh1, n + 16384, int8_epilogue=epi)
        timing(f"phase {label} ingest (add_batch of {n} rows, {db.n_shards} "
               f"shard of {db.per_shard})", took, "s")
        sharded_cell(f"{label} search -> fused", db.search, queries, gt,
                     "raw fused")
        add(read_launches(label, must_launch=(kernel,)))
        peak(label)
        return db

    db = fused_db("per_row", "fused_int8_pool")
    label = "11a raw mesh1"
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    timed_host(f"{label} train_pq (S=64, K=256, 10 iterations + encode)",
               lambda: db.train_pq(num_centroids=256, iters=10))
    sharded_cell(f"{label} search_flagship refine=1024",
                 lambda q, k: db.search_flagship(q, k, refine=1024),
                 queries, gt, "raw flagship")
    add(read_launches(f"{label} flagship",
                      must_launch=("pq_decode_recon_t",)))
    timed_host(f"{label} fit_pca p=128", lambda: db.fit_pca(p=128))
    sharded_cell(f"{label} search_pca select_r=256",
                 lambda q, k: db.search_pca(q, k, select_r=256),
                 queries, gt, "raw pca")
    peak(f"{label} flagship + pca")
    # CRUD: remove 1% of the rows, add 10,000 new ones
    reset_launches()
    gone = np.arange(0, n, 100)
    new = torch.randn(10_000, DIM, device=DEVICE,
                      generator=gen.manual_seed(43))
    new_ids = np.arange(n, n + 10_000)

    def crud():
        for vid in gone.tolist():
            db.remove(vid)
        return db.add_batch(new_ids, new)
    acc = timed_host(f"{label} CRUD (remove {gone.size}, add 10,000)", crud)
    hits = float((db.search(new, 1)[0][:, 0] == new_ids).mean())
    back = int(np.isin(db.search(corpus[gone[:NQ]], K)[0], gone).sum())
    say(f"phase {label} CRUD: accepted {len(acc)}, rows {db.size()}, new "
        f"rows found by their own vectors {hits}, removed ids returned "
        f"{back}")
    add(read_launches(f"{label} CRUD", must_launch=("fused_int8_pool",)))
    if len(acc) != 10_000 or hits < 1.0 or back:
        raise RuntimeError(f"{label}: CRUD round failed")
    del db
    fused_db("global", "fused_int8g_pool")  # dropped on return
    torch.cuda.empty_cache()
    label = "11a raw mesh4"
    mesh4 = sh.make_mesh(devices=[DEVICE] * 4)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    db, took = ingest(mesh4, n)
    timing(f"phase {label} ingest (add_batch of {n} rows, 4 shards of "
           f"{db.per_shard})", took, "s")
    if db.size() >= db.fused_threshold * db.n_shards:
        raise RuntimeError(f"{label}: search would not take the exact scan")
    ids = sharded_cell(f"{label} search -> exact", db.search, queries, gt,
                       "exact")
    d = db.search(queries, K)[1]
    same = ids == gt_i.cpu().numpy()
    rows = ~same.all(1)
    tied = np.allclose(np.sort(d[rows], 1), gt_d.cpu().numpy()[rows],
                       rtol=1e-5, atol=1e-4)
    say(f"phase {label}: ids equal the single-chip blocked_knn top-10 at "
        f"{same.mean()} of positions; {int(rows.sum())} queries differ, "
        f"their distances equal within 1e-5: {tied}")
    if same.mean() < 0.999 or not tied:
        raise RuntimeError(f"{label}: exact search differs from one chip")
    add(read_launches(label, must_not=POOL_KERNELS))
    reset_launches()
    sharded_cell(f"{label} search_fused", db.search_fused, queries, gt,
                 "raw fused")
    got = read_launches(f"{label} search_fused",
                        must_launch=("fused_int8_pool",))
    add(got)
    reset_launches()
    db.search_fused(queries, K)
    one = read_launches(f"{label} one search_fused call")["fused_int8_pool"]
    if one != 4:
        raise RuntimeError(f"{label}: {one} B2 launches a call, not 4")
    peak(label)
    del db, corpus
    torch.cuda.empty_cache()


def sharded_compressed(counts):
    """11b: the Compressed 10M corpus on four logical shards, compressed +
    residual with host_mirror=False, by bulk_load_stream: search (fused:
    B4 on each shard), search_flagship (B3), search_pca, the exact int8
    scan; save (payload_sharded) and load onto one shard, the exact scan's
    ids and distances the same."""
    from vector_db_torch.parallel import sharded as sh

    n = N_10M_CHUNK * SHARDED_10M_CHUNKS
    queries = torch.randn(
        NQ, DIM, device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(7)) * spectrum()
    known = GT_10M["gt"] if SHARDED_10M_CHUNKS == N_10M_CHUNKS else None
    work = {"seconds": 0.0}
    label = "11b compressed mesh4"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    db = sh.ShardedDatabase(sh.make_mesh(devices=[DEVICE] * 4), dim=DIM,
                            capacity=n, num_subspaces=64, raw_store=False,
                            refine_residual=True, host_mirror=False)
    t0 = time.perf_counter()
    rows = db.bulk_load_stream(
        stream_spectral(queries, work, SHARDED_10M_CHUNKS, known),
        num_centroids=256, iters=10)
    torch.cuda.synchronize()
    timing(f"phase {label} ingest (bulk_load_stream of {rows} rows, 4 "
           f"shards of {db.per_shard}: train + pack + residual + encode; "
           "generation and ground truth excluded)",
           time.perf_counter() - t0 - work["seconds"], "s")
    gt = work["gt"]
    if rows != n or hasattr(db, "_h_packed"):
        raise RuntimeError(f"{label}: {rows} rows, or a host payload")

    def add(c):
        for name in counts:
            counts[name] += c[name]

    add(read_launches(f"{label} ingest"))
    reset_launches()
    sharded_cell(f"{label} search -> fused", db.search, queries, gt,
                 "compressed fused")
    add(read_launches(f"{label} fused", must_launch=("fused_packed_pool",)))
    reset_launches()
    sharded_cell(f"{label} search_flagship refine=1024",
                 lambda q, k: db.search_flagship(q, k, refine=1024),
                 queries, gt, "compressed flagship")
    add(read_launches(f"{label} flagship",
                      must_launch=("pq_decode_recon_t",)))
    reset_launches()
    timed_host(f"{label} fit_pca p=64", lambda: db.fit_pca(p=64))
    sharded_cell(f"{label} search_pca select_r=512",
                 lambda q, k: db.search_pca(q, k, select_r=512),
                 queries, gt, "compressed pca")
    add(read_launches(f"{label} pca", must_not=tuple(KERNELS)))
    peak(label)
    # the exact int8 scan of both levels (the route below the threshold),
    # whose answer does not depend on the slot layout
    db.fused_threshold = 1 << 62
    before = sharded_cell(f"{label} exact int8 scan", db.search, queries, gt,
                          "exact")
    before_d = db.search(queries, K)[1]
    path = os.path.join(WORK, "sharded10m")
    shutil.rmtree(path, ignore_errors=True)
    timed_host(f"{label} save (payload_sharded)", lambda: db.save(path))
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    timing(f"phase {label} checkpoint bytes", size, "B")
    del db
    torch.cuda.empty_cache()
    label = "11b compressed load mesh1"
    reset_launches()
    db = timed_host(f"{label} load", lambda: sh.ShardedDatabase.load(
        sh.make_mesh(devices=[DEVICE]), path, host_mirror=False))
    shutil.rmtree(path, ignore_errors=True)
    db.fused_threshold = 1 << 62
    after, after_d = db.search(queries, K)
    same = bool((after == before).all() and np.array_equal(after_d, before_d))
    say(f"phase {label}: rows {db.size()}, exact int8 scan ids and "
        f"distances identical after the reload: {same} (ids "
        f"{float((after == before).mean())}, max |d| diff "
        f"{float(np.abs(after_d - before_d).max())})")
    if db.size() != n or not (after == before).all():
        raise RuntimeError(f"{label}: the reloaded database differs")
    del db.fused_threshold
    sharded_cell(f"{label} search -> fused", db.search, queries, gt,
                 "compressed fused")
    add(read_launches(label, must_launch=("fused_packed_pool",)))
    peak(label)
    del db
    torch.cuda.empty_cache()


def phase_sharded():
    """11: the sharded tier (vector_db_torch/parallel/sharded.py) on the
    card; returns the launch counts of its paths."""
    counts = {name: 0 for name in KERNELS}
    t_start = time.perf_counter()
    for part in (sharded_raw, sharded_compressed):
        t0 = time.perf_counter()
        part(counts)
        timing(f"phase 11 {part.__name__} took", time.perf_counter() - t0,
               "s")
    timing("phase 11 took", time.perf_counter() - t_start, "s")
    for name in ("fused_int8_pool", "fused_int8g_pool", "fused_packed_pool",
                 "pq_decode_recon_t"):
        if counts[name] == 0:
            raise RuntimeError(f"phase 11 never launched {name}")
    say(f"phase 11: kernel launches {json.dumps(counts)}")
    return counts


# ------------------------------------------------------------ phase 12
#: 12a: the spanning mesh at phase 11a's size: 4 shards of 262,144 x 512
SPAN_SHARDS, SPAN_PER_SHARD = 4, 262_144
#: 12b: gloo ranks on the one card, each holding SPAN_SHARDS / SPAN_RANKS
SPAN_RANKS = 2
#: 12a/12b: raw fused recall@10 floor (phase 11a's, the single-chip one)
SPAN_FUSED_FLOOR = 0.95
#: 12d: recall@10 floors of the two examples' rows at their default sizes:
#: this script's first full run on an H100 less 0.01 (no reference figure
#: exists at these sizes); BRUTE must also be exact
EXAMPLE_FLOORS = {
    "vector_database": {"brute": 0.99, "hnsw": 0.94, "hnswpq": 0.99,
                        "ivf": 0.988, "pq": 0.713, "lsh": 0.96,
                        "annoy": 0.953},
    "compression": {"uncompressed": 0.988, "recommended (dim/8, 32x)": 0.99,
                    "high recall (dim/4, 16x)": 0.99,
                    "high compression (dim/16, 64x)": 0.99,
                    "memory-bound (adc_fast, 32x)": 0.99,
                    "pca proxy (dim/8 dims + refine)": 0.99,
                    "compressed store (no raw f32, 4x)": 0.981,
                    "compressed + residual (2.5x)": 0.99},
}


def span_argv(url, rank, world, local, backend):
    return ["--coordinator", url, "--num-processes", str(world),
            "--process-id", str(rank), "--local-shards", str(local),
            "--per-shard", str(SPAN_PER_SHARD), "--dim", str(DIM),
            "--device", DEVICE, "--backend", backend]


def span_programs(mesh, vectors, queries):
    """The exact and the fused (B2) program over ``mesh`` and its sharded
    ``vectors`` (all live; norms shard-local, as the example's): their
    (dists, ids) at ``queries``, and the two programs as callables."""
    from vector_db_torch.ops.distance import sq_norms
    from vector_db_torch.ops.kernels import preserved_pool_width
    from vector_db_torch.parallel import sharded as sh

    valid = [torch.ones(v.shape[0], dtype=torch.bool, device=v.device)
             for v in vectors]
    norms = [sq_norms(v) for v in vectors]
    cond = sh.sharded_cond_raw8(mesh)(vectors, norms, valid)
    w = preserved_pool_width(SPAN_PER_SHARD)
    exact = sh.sharded_knn(mesh, K)
    fused = sh.sharded_fused_raw8(mesh, K, 64, w)

    def run_exact(q):
        return exact(q, vectors, valid, norms)

    def run_fused(q):
        return fused(q, vectors, *cond)
    return run_exact(queries), run_fused(queries), run_exact, run_fused


def span_queries(n):
    rng = np.random.default_rng(7)
    return torch.from_numpy(
        rng.standard_normal((n, DIM)).astype(np.float32)).to(DEVICE)


def as_np(pair):
    return tuple(t.cpu().numpy() for t in pair)


def span_rank(rank, url, out_path):
    """12b: one gloo rank on the card (spawned): the example, then the
    exact and fused programs at Q=1024 over its own shards (the example's
    ``local_corpus``) with their host walls; saved to ``out_path`` +
    rank."""
    import torch.distributed as dist

    from vector_db_torch.examples import multiprocess_dcn as dcn
    from vector_db_torch.ops import kernels as kn
    from vector_db_torch.parallel import sharded as sh

    torch.cuda.set_device(0)
    local = SPAN_SHARDS // SPAN_RANKS
    try:
        d, idx = dcn.main(span_argv(url, rank, SPAN_RANKS, local, "gloo"))
        mesh = sh.make_mesh(devices=[DEVICE] * local, group=dist.group.WORLD)
        vectors = dcn.local_corpus(mesh, SPAN_PER_SHARD, DIM)[0]
        q = span_queries(NQ)
        exact, fused, run_exact, run_fused = span_programs(mesh, vectors, q)
        walls = [host_s(lambda: as_np(run(q))) for run in (run_exact,
                                                           run_fused)]
        np.savez(f"{out_path}{rank}.npz", d=d, idx=idx,
                 exact_d=exact[0].cpu().numpy(),
                 exact_i=exact[1].cpu().numpy(),
                 fused_d=fused[0].cpu().numpy(),
                 fused_i=fused[1].cpu().numpy(), walls=np.asarray(walls),
                 b2=np.asarray(kn.fused_int8_pool.launches))
    finally:
        dist.destroy_process_group()


def span_single_rank(counts):
    """12a: the example over a file:// NCCL group of one rank holding 4
    shards of the card (2^20 x 512 rows), held bit for bit to the
    single-controller mesh over the same rows (generated globally, split
    by shard_corpus); the fused program (B2) over the same spanning mesh,
    its ids equal to the single controller's; recall against the exact
    search, host walls at Q=64 and Q=1024, a profiled call of each.
    Returns 12a's results for 12b."""
    import torch.distributed as dist

    from vector_db_torch.examples import multiprocess_dcn as dcn
    from vector_db_torch.parallel import sharded as sh

    label = "12a nccl world 1"
    os.makedirs(WORK, exist_ok=True)
    rdzv = os.path.join(WORK, "rdzv12a")
    if os.path.exists(rdzv):
        os.remove(rdzv)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    d, idx = dcn.main(span_argv(f"file://{rdzv}", 0, 1, SPAN_SHARDS, "nccl"))
    torch.cuda.synchronize()
    timing(f"phase {label} multiprocess_dcn.main ({SPAN_SHARDS} shards of "
           f"{SPAN_PER_SHARD} x {DIM}, rows generated on the host)",
           time.perf_counter() - t0, "s")
    try:
        span = sh.make_mesh(devices=[DEVICE] * SPAN_SHARDS,
                            group=dist.group.WORLD)
        single = sh.make_mesh(devices=[DEVICE] * SPAN_SHARDS)
        say(f"phase {label}: backend {dist.get_backend()}, rank "
            f"{span.rank} of {span.world}, global shards "
            f"{span.global_shards}, local {span.local_shards}")
        rows = torch.from_numpy(np.concatenate(
            [dcn.shard_rows(s, SPAN_PER_SHARD, DIM)
             for s in range(SPAN_SHARDS)])).to(DEVICE)
        (span_rows,) = sh.shard_process_local(span, rows)
        (single_rows,) = sh.shard_corpus(single, rows)
        del rows
        q64, q = span_queries(dcn.NQ), span_queries(NQ)
        exact, fused, run_exact, run_fused = span_programs(span, span_rows, q)
        s_exact64, _f, _e, s_run_fused = span_programs(single, single_rows,
                                                       q64)
        same = (np.array_equal(d, s_exact64[0].cpu().numpy())
                and np.array_equal(idx, s_exact64[1].cpu().numpy()))
        say(f"phase {label}: the example's ids and distances equal the "
            f"single-controller sharded_knn bit for bit: {same}")
        if not same:
            raise RuntimeError(f"{label}: the spanning mesh differs")
        s_fused = s_run_fused(q)
        ids_same = torch.equal(fused[1], s_fused[1])
        say(f"phase {label}: fused ids equal the single controller's: "
            f"{ids_same}; distances equal: "
            f"{torch.equal(fused[0], s_fused[0])}")
        if not ids_same:
            raise RuntimeError(f"{label}: fused ids differ")
        del single_rows, s_run_fused, _e
        gt = exact[1].cpu().tolist()
        hold_floor(f"{label} fused (Q={NQ}) against the exact search",
                   recall(fused[1].cpu().tolist(), gt), SPAN_FUSED_FLOOR)
        for name, run in (("exact", run_exact), ("fused", run_fused)):
            for qq in (q64, q):
                timing(f"phase {label} {name} host wall (Q={qq.shape[0]}, "
                       f"k={K}, best of 3)",
                       host_s(lambda: as_np(run(qq))) * 1e3, "ms")
            profile_search(f"{label} {name} Q={NQ}", lambda: run(q))
        for name, c in read_launches(label, must_launch=(
                "fused_int8_pool",)).items():
            counts[name] += c
        reset_launches()
        run_fused(q)
        one = read_launches(f"{label} one fused call")["fused_int8_pool"]
        counts["fused_int8_pool"] += one
        if one != SPAN_SHARDS:
            raise RuntimeError(f"{label}: {one} B2 launches a call")
        peak(label)
        result = dict(d=d, idx=idx, exact=as_np(exact), fused=as_np(fused))
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return result


def span_two_ranks(counts, want):
    """12b: two gloo ranks spawned on the one card, each holding 2 of 12a's
    4 shards: every rank returns 12a's ids and distances for the example,
    the exact and the fused program; the winners cross through host
    memory."""
    import torch.multiprocessing as mp

    label = "12b gloo world 2"
    rdzv = os.path.join(WORK, "rdzv12b")
    if os.path.exists(rdzv):
        os.remove(rdzv)
    out = os.path.join(WORK, "rank12b_")
    t0 = time.perf_counter()
    mp.spawn(span_rank, args=(f"file://{rdzv}", out), nprocs=SPAN_RANKS,
             join=True)
    timing(f"phase {label} spawn to join (two ranks: CUDA init, rows, the "
           "example, both programs timed)", time.perf_counter() - t0, "s")
    for r in range(SPAN_RANKS):
        got = np.load(f"{out}{r}.npz")
        same = [np.array_equal(got[a], w) for a, w in (
            ("d", want["d"]), ("idx", want["idx"]),
            ("exact_d", want["exact"][0]), ("exact_i", want["exact"][1]),
            ("fused_d", want["fused"][0]), ("fused_i", want["fused"][1]))]
        say(f"phase {label} rank {r}: equal to 12a (example d, ids; exact "
            f"d, ids; fused d, ids): {same}; B2 launches "
            f"{int(got['b2'])}")
        if not all(same[:4]) or not same[5]:
            raise RuntimeError(f"{label}: rank {r} differs from 12a")
        for name, wall in zip(("exact", "fused"), got["walls"]):
            timing(f"phase {label} rank {r} {name} host wall (Q={NQ}, "
                   f"k={K}, best of 3, winners through host memory)",
                   wall * 1e3, "ms")
        counts["fused_int8_pool"] += int(got["b2"])
        os.remove(f"{out}{r}.npz")
    if counts["fused_int8_pool"] == 0:
        raise RuntimeError(f"{label}: the ranks never launched B2")


def span_graft_entry(counts):
    """12c: graft_entry.entry() on the card, then dryrun_multichip(4) on
    [cuda:0] * 4 (the reference's own tiny shapes): B7, B4 and B3 must
    launch."""
    from vector_db_torch import graft_entry as ge

    label = "12c graft entry"
    reset_launches()
    t0 = time.perf_counter()
    fn, args = ge.entry(device=DEVICE)
    d, ext = fn(*args)
    ok = (tuple(d.shape) == (8, 8) and tuple(ext.shape) == (8, 8)
          and bool(((ext >= 0) & (ext < args[4].shape[0])).all()))
    say(f"phase {label}: entry() on {args[0].device}: shapes "
        f"{tuple(d.shape)} {tuple(ext.shape)}, valid ids {ok}")
    if not ok:
        raise RuntimeError(f"{label}: entry() gave wrong results")
    ge.dryrun_multichip(4, device=DEVICE)
    torch.cuda.synchronize()
    timing(f"phase {label} entry + dryrun_multichip(4)",
           time.perf_counter() - t0, "s")
    for name, c in read_launches(label, must_launch=(
            "fused_int8g_pool", "fused_packed_pool",
            "pq_decode_recon_t")).items():
        counts[name] += c


def hold_example(label, rows, key, floors):
    """BRUTE exact; every row at or above its floor."""
    if [row[key] for row in rows] != list(floors):
        raise RuntimeError(f"{label}: rows {[row[key] for row in rows]}")
    for row in rows:
        name, rec = row[key], row["recall"]
        if name == "brute" and rec != 1.0:
            raise RuntimeError(f"{label}: BRUTE recall {rec}")
        hold_floor(f"{label} row {name!r}", rec, floors[name])


def span_examples(counts):
    """12d: the two table examples at their default sizes on the card."""
    from vector_db_torch.examples import compression_example as ce
    from vector_db_torch.examples import vector_database_example as vde

    for label, mod, key, floors, must in (
            ("12d vector_database_example (10,000 x 128)", vde, "index",
             EXAMPLE_FLOORS["vector_database"], ("pq_decode_recon_t",)),
            ("12d compression_example (10,000 x 512)", ce, "preset",
             EXAMPLE_FLOORS["compression"],
             ("pq_decode_recon_t", "fused_packed_pool"))):
        reset_launches()
        t0 = time.perf_counter()
        rows = mod.main(["--device", DEVICE])
        timing(f"phase {label} took", time.perf_counter() - t0, "s")
        hold_example(label, rows, key, floors)
        for name, c in read_launches(label, must_launch=must).items():
            counts[name] += c


def phase_span():
    """12: the multi-process sharded path, the graft entry and the two
    examples on the card; returns the launch counts of its paths."""
    counts = {name: 0 for name in KERNELS}
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    want = span_single_rank(counts)
    timing("phase 12a took", time.perf_counter() - t0, "s")
    for part, arg in ((span_two_ranks, want), (span_graft_entry, None),
                      (span_examples, None)):
        t0 = time.perf_counter()
        part(counts, *(() if arg is None else (arg,)))
        timing(f"phase 12 {part.__name__} took", time.perf_counter() - t0,
               "s")
    timing("phase 12 took", time.perf_counter() - t_start, "s")
    for name in ("fused_int8_pool", "fused_int8g_pool", "fused_packed_pool",
                 "pq_decode_recon_t"):
        if counts[name] == 0:
            raise RuntimeError(f"phase 12 never launched {name}")
    say(f"phase 12: kernel launches {json.dumps(counts)}")
    return counts


# ---------------------------------------------------------------- phase 13
#: 13a: bench.py's two 100k x 512 corpora, the flagship's gaussian rows
#: (bench.py:36-46) and the memory-bound spectral rows (bench.py:148-166),
#: each mode on the corpus of its PERF.md section 2 floor
N_CROSS = 100_000
CAP_CROSS = 131_072
CROSS_DELETE, CROSS_READD, CROSS_ADD = 10_000, 2_000, 20_000
#: re-added rows scaled x10: more than 1% of the live rows then clip against
#: the global shadow's scale, so its clip rebuild runs
CROSS_WIDE = 1_024
CROSS_SINGLE = 16
#: checkpoints only at the reload step (close + build): the WAL carries every
#: op in between; 13c runs the default interval
CROSS_FLUSH = 1 << 30
CROSS_DBS = {  # name -> (corpus, metric, HnswPqConfig fields)
    "gauss": ("gauss", "l2", dict(CFG)),
    "cosine": ("gauss", "cosine", dict(CFG, search_mode="scan_pallas_int8")),
    "packed": ("gauss", "l2", dict(CFG, raw_store=False,
                                   search_mode="scan_pallas_int8")),
    "resid": ("gauss", "l2", dict(CFG, raw_store=False, refine_residual=True,
                                  search_mode="scan_pallas_int8")),
    "spectral": ("spectral", "l2", dict(CFG, nlist=256, nprobe=32)),
}
#: (label, database, config fields set for the search, kernel, exact, floor)
#: floors: PERF.md section 2 (raw exhaustive modes 0.95, compressed
#: scan_pallas_int8 0.96, memory-bound adc_fast and fused 0.96, scan_ivf 0.93)
CROSS_MODES = (
    ("per_row l2", "gauss", dict(search_mode="scan_pallas_int8",
                                 int8_epilogue="per_row"),
     "fused_int8_pool", True, 0.95),
    ("global l2", "gauss", dict(search_mode="scan_pallas_int8",
                                int8_epilogue="global"),
     "fused_int8g_pool", True, 0.95),
    ("scan_pallas l2", "gauss", dict(search_mode="scan_pallas",
                                     int8_epilogue="per_row"),
     "fused_raw_pool", True, 0.95),
    ("per_row cosine", "cosine", {}, "fused_int8_pool", True, 0.95),
    ("compressed", "packed", {}, "fused_packed_pool", False, 0.96),
    ("compressed + residual", "resid", {}, "fused_packed_pool", True, 0.96),
    ("adc_fast", "spectral", dict(search_mode="adc_fast", adc_pool="approx"),
     "pq_decode_recon_t", False, 0.96),
    ("adc_fast fused", "spectral", dict(search_mode="adc_fast",
                                        adc_pool="fused"),
     "fused_adc_pool", False, 0.96),
    ("scan_ivf", "spectral", dict(search_mode="scan_ivf"), "fused_ivf_pool",
     False, 0.93),
)
#: 13b: thread counts, calls a thread, and the writer's race
CROSS_THREADS = (1, 2, 4, 8)
RACE_ADDS, RACE_DELETES = 1_000, 500
#: 13c: the crash child's writes after its add_batch
CRASH_ADDS, CRASH_DELETES = 1_000, 100
#: 13d: phase 9's sequential-insert shape, TestBoundedFlush's checks
FLUSH_MIN, FLUSH_CHUNK, FLUSH_BATCH = 512, 256, 256


@contextlib.contextmanager
def uncounted():
    """Kernel launches inside do not count toward the path's: the checks'
    own calls (a kernel against its plain version, fresh builds)."""
    from vector_db_torch.ops import kernels as kn

    saved = {name: getattr(kn, name).launches for name in KERNELS}
    try:
        yield
    finally:
        for name, c in saved.items():
            getattr(kn, name).launches = c


@contextlib.contextmanager
def spying(targets):
    """Wrap each (module, name): every call runs as before and its
    arguments and result are kept in ``seen[name]`` (the last call's)."""
    seen, saved = {}, []
    for mod, name in targets:
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            seen[_name] = (a, kw, out)
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, spy)
    try:
        yield seen
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def kernel_sites():
    """The (module, name) of every kernel call on the index path."""
    import vector_db_torch.index.hnsw_pq as hp
    import vector_db_torch.ops.adc as adc
    import vector_db_torch.ops.ivf_scan as ivs

    return ([(hp, n) for n in ("fused_int8_pool", "fused_int8g_pool",
                               "fused_packed_pool", "fused_raw_pool")]
            + [(adc, "pq_decode_recon_t"), (adc, "fused_adc_pool"),
               (ivs, "fused_ivf_pool")])


class Oracle:
    """The live set as the oracle sees it: rows by external id on the card,
    distances in float64 by plain torch (not the port's blocked_knn)."""

    def __init__(self, n_ids):
        self.rows = torch.zeros(n_ids, DIM, device=DEVICE)
        self.alive = torch.zeros(n_ids, dtype=torch.bool, device=DEVICE)

    def copy(self):
        other = Oracle(0)
        other.rows, other.alive = self.rows.clone(), self.alive.clone()
        return other

    def put(self, ids, rows):
        self.rows[ids] = rows
        self.alive[ids] = True

    def drop(self, ids):
        self.alive[ids] = False

    def live_ids(self):
        return torch.nonzero(self.alive).flatten()

    def dist(self, q, metric):
        """[Q, ids] float64 distances, +inf at dead ids."""
        q64, r64 = q.double(), self.rows.double()
        if metric == "cosine":
            qn = q64 / q64.norm(dim=1, keepdim=True).clamp(min=1e-300)
            rn = r64 / r64.norm(dim=1, keepdim=True).clamp(min=1e-300)
            d = 1.0 - qn @ rn.T
        else:
            d = ((q64 * q64).sum(1)[:, None] + (r64 * r64).sum(1)[None, :]
                 - 2.0 * (q64 @ r64.T)).clamp_(min=0.0)
        return d.masked_fill_(~self.alive[None, :], float("inf"))


def as_arrays(rows):
    """SearchResult rows -> (ids [Q, K] int64, dists [Q, K] f64) on the
    card, -1 / +inf where a row is short."""
    ids = torch.full((len(rows), K), -1, dtype=torch.long)
    dists = torch.full((len(rows), K), float("inf"), dtype=torch.float64)
    for i, row in enumerate(rows):
        if row:
            ids[i, :len(row)] = torch.tensor([r.id for r in row])
            dists[i, :len(row)] = torch.tensor([r.distance for r in row],
                                               dtype=torch.float64)
    return ids.to(DEVICE), dists.to(DEVICE)


def tie_band(d, k):
    """Per row of a [Q, c] f64 matrix: (kth, eps) of the reference's
    oracle (test_oracle_fuzz.py:24-51): eps = 1e-4 (1 + |kth|)."""
    kth = torch.topk(d, k, dim=1, largest=False).values[:, -1]
    return kth, 1e-4 * (1.0 + kth.abs())


def exact_set(ids, d_got, d_pool, n_live):
    """The exact-set rule per query: ``must`` (strictly inside the top-k by
    more than eps) in the result, the result inside ``ok`` (within eps of
    the k-th), k distinct ids (or every live one).  ``d_got`` [Q, K] is the
    oracle's distance of each returned id (+inf for -1 or an id outside the
    pool), ``d_pool`` [Q, c] the oracle's distances over the set the result
    must be exact on.  Returns a [Q] bool."""
    k = min(K, n_live)
    kth, eps = tie_band(d_pool, k)
    n_must = (d_pool < (kth - eps)[:, None]).sum(1)
    got = ids[:, :k]
    srt = torch.sort(got, dim=1).values
    distinct = (srt[:, 1:] != srt[:, :-1]).all(1) if k > 1 else \
        torch.ones_like(kth, dtype=torch.bool)
    inside = (d_got[:, :k] <= (kth + eps)[:, None]).all(1)
    has_must = (d_got[:, :k] < (kth - eps)[:, None]).sum(1) == n_must
    return (got >= 0).all(1) & distinct & inside & has_must


def hold_rows(label, ids, dists, oracle):
    """No dead ids, no -1 (k ids a row), distances ascending."""
    live = oracle.alive[ids.clamp(min=0)] & (ids >= 0)
    sorted_ok = bool((dists[:, 1:] >= dists[:, :-1]).all())
    if not bool(live.all()) or not sorted_ok:
        raise RuntimeError(f"{label}: {int((~live).sum())} dead or missing "
                           f"ids, ascending distances {sorted_ok}")


def hold_exact(label, ids, dists, d_full, cands, st_ids, oracle, slack):
    """The exact modes: the exact-set rule over the pool the search scored
    (``cands``: its candidate slots, from the search itself) for every
    query and, on a raw store (an f32 refine; ``slack`` [Q, K] its
    rounding, else None), reported distances equal to the oracle's within
    its eps plus that slack; the exact-set rule over the whole live set is
    printed (a strided-bucket pool keeps one row of ~50 a bucket, so at
    100k rows a neighbour can lose its bucket: the pool modes are exact
    over their pool, the reference's at any size)."""
    n_live = int(oracle.alive.sum())
    d_got = d_full.gather(1, ids.clamp(min=0))
    d_got = torch.where(ids >= 0, d_got, float("inf"))
    dist_ok = slack is None or bool(
        ((dists - d_got).abs() <= 1e-4 * (1.0 + d_got.abs()) + slack).all())
    whole = exact_set(ids, d_got, d_full, n_live)
    cand_ids = torch.where(cands >= 0, st_ids[cands.clamp(min=0).long()]
                           .long(), -1)
    d_pool = torch.where(cand_ids >= 0, d_full.gather(
        1, cand_ids.clamp(min=0)), float("inf"))
    in_pool = (ids[:, :, None] == cand_ids[:, None, :]).any(2)
    pool_rule = exact_set(ids, torch.where(in_pool, d_got, float("inf")),
                          d_pool, n_live)
    say(f"phase {label}: exact over the pool {int(pool_rule.sum())}/"
        f"{ids.shape[0]}, exact over the live set {int(whole.sum())}/"
        f"{ids.shape[0]}, distances equal the oracle's "
        f"{dist_ok if slack is not None else '(not an f32 refine)'}")
    if not bool(pool_rule.all()) or not dist_ok:
        raise RuntimeError(f"{label}: not exact over its pool")
    return int(whole.sum())


def f32_slack(q, ids, oracle, metric):
    """The f32 refine's rounding of an L2 distance by the norm identity,
    |q|^2 + |v|^2 - 2 q.v: a few ulps of |q|^2 + |v|^2 (cosine's distances
    are of unit rows: none)."""
    if metric != "l2":
        return torch.zeros(ids.shape, dtype=torch.float64, device=DEVICE)
    qn = (q.double() ** 2).sum(1)
    vn = (oracle.rows[ids.clamp(min=0)].double() ** 2).sum(-1)
    return 1e-5 * (qn[:, None] + vn)


def cross_recall(ids, d_full):
    gt = torch.topk(d_full, K, dim=1, largest=False).indices
    return float((ids[:, :, None] == gt[:, None, :]).any(2).sum()) / (
        K * ids.shape[0])


def cross_queries(oracle, gen):
    """1,024 noisy copies (sigma 0.01) of live rows, drawn anew."""
    live = oracle.live_ids()
    pick = live[torch.randint(0, live.numel(), (NQ,), device=DEVICE,
                              generator=gen)]
    return oracle.rows[pick] + 0.01 * torch.randn(
        NQ, DIM, device=DEVICE, generator=gen)


def cross_db(name, path):
    from vector_db_torch import HnswPqConfig, IndexType, VectorDatabase

    _, metric, cfg = CROSS_DBS[name]
    return VectorDatabase(DIM, CAP_CROSS, IndexType.HNSWPQ, metric, path,
                          index_config=HnswPqConfig(**cfg),
                          flush_interval=CROSS_FLUSH, device=DEVICE)


def cross_schedule():
    """The reference's schedule scaled: per step (op, ids, gaussian rows,
    spectral rows); re-added rows are new draws, CROSS_WIDE of them x10."""
    g = torch.Generator(device=DEVICE).manual_seed(1301)
    scale = spectrum()
    live = torch.ones(N_CROSS + CROSS_ADD, dtype=torch.bool, device=DEVICE)
    live[N_CROSS:] = False
    deleted = []

    def rows(n, wide=0):
        gauss = torch.randn(n, DIM, device=DEVICE, generator=g)
        gauss[:wide] *= 10.0
        return gauss, torch.randn(n, DIM, device=DEVICE, generator=g) * scale

    def victims():
        ids = torch.nonzero(live).flatten()
        out = ids[torch.randperm(ids.numel(), device=DEVICE,
                                 generator=g)[:CROSS_DELETE]]
        live[out] = False
        deleted.append(out)
        return out

    steps = [("add", torch.arange(N_CROSS, device=DEVICE), *rows(N_CROSS))]
    steps.append(("delete", victims(), None, None))
    readd = deleted[0][:CROSS_READD]
    live[readd] = True
    steps.append(("re-add", readd, *rows(CROSS_READD, CROSS_WIDE)))
    steps.append(("reload", None, None, None))
    new = torch.arange(N_CROSS, N_CROSS + CROSS_ADD, device=DEVICE)
    live[new] = True
    steps.append(("add", new, *rows(CROSS_ADD)))
    steps.append(("delete", victims(), None, None))
    return steps


def cross_apply(dbs, paths, op, ids, rows_by_corpus):
    """One step on every database; returns the new handles after a
    reload."""
    for name, db in list(dbs.items()):
        corpus = CROSS_DBS[name][0]
        if op in ("add", "re-add"):
            got = db.add_batch(ids.tolist(), rows_by_corpus[corpus])
            if len(got) != ids.numel():
                raise RuntimeError(f"13a {name}: {op} accepted {len(got)} "
                                   f"of {ids.numel()}")
        elif op == "delete":
            for vid in ids.tolist():
                if not db.delete_vector(vid):
                    raise RuntimeError(f"13a {name}: delete {vid} refused")
        else:
            db.close()
            dbs[name] = cross_db(name, paths[name])
    torch.cuda.synchronize()


def fresh_index(name, oracle):
    """An index built anew from the live set under the database's
    config."""
    from vector_db_torch import HnswPqConfig
    from vector_db_torch.index.hnsw_pq import HnswPqIndex

    _, metric, cfg = CROSS_DBS[name]
    ids = oracle.live_ids()
    rows = oracle.rows[ids]
    index = HnswPqIndex(DIM, CAP_CROSS, metric, HnswPqConfig(**cfg),
                        device=DEVICE)
    if cfg.get("raw_store", True):
        index.bulk_load(ids.tolist(), rows)
    else:
        step = 32_768
        index.bulk_load_stream((ids[s:s + step].tolist(), rows[s:s + step])
                               for s in range(0, ids.numel(), step))
    return index


def set_mode(index, fields):
    for key, value in fields.items():
        setattr(index.config, key, value)


def cross_check(step, dbs, oracles, gens, last):
    """Every mode after one step: the exact modes by the exact-set rule over
    their pool and the oracle's distances, the approximate ones at their
    floor and at a fresh build's recall less 0.01; no dead ids, no -1,
    ascending distances everywhere.  On the last step, returns the
    arguments each kernel got in its mode's batch search (Q=1,024)."""
    import vector_db_torch.index.hnsw_pq as hp

    queries = {c: cross_queries(o, gens[c]) for c, o in oracles.items()}
    fresh, captured, dist = {}, {}, {}
    for label, name, fields, kernel, exact, floor in CROSS_MODES:
        t0 = time.perf_counter()
        db = dbs[name]
        corpus, metric, _ = CROSS_DBS[name]
        oracle, q = oracles[corpus], queries[corpus]
        set_mode(db.index, fields)
        with spying([(hp, "_pool_select_cand")] + kernel_sites()) as seen:
            ids, dists = as_arrays(db.search_batch(q, K))
            cands = seen.get("_pool_select_cand", (None, None, None))[2]
            if last:
                captured[label] = dict(seen)
            singles, single_cands = [], []
            for i in range(CROSS_SINGLE):
                if exact:
                    # a graph replay runs no Python: with the graphs
                    # dropped the call runs eagerly and the spy sees its pool
                    db.index._q8.clear()
                singles.append(db.search(q[i], K))
                if exact:
                    single_cands.append(seen["_pool_select_cand"][2][:1])
        s_ids, s_dists = as_arrays(singles)
        if metric == "l2":  # the facade reports the L2 distance, not its square
            dists, s_dists = dists.square(), s_dists.square()
        if (corpus, metric) not in dist:
            dist[corpus, metric] = oracle.dist(q, metric)
        d_full = dist[corpus, metric]
        d_single = d_full[:CROSS_SINGLE]
        tag = f"13a {label} after {step}"
        hold_rows(tag, ids, dists, oracle)
        hold_rows(tag + " (single queries)", s_ids, s_dists, oracle)
        rec = cross_recall(ids, d_full)
        note = ""
        if exact:
            st_ids = db.index.store.state.ids
            slack = (f32_slack(q, ids, oracle, metric)
                     if db.index.store.raw else None)
            hold_exact(tag, ids, dists, d_full, cands, st_ids, oracle, slack)
            hold_exact(tag + " (single queries)", s_ids, s_dists, d_single,
                       torch.cat(single_cands), st_ids, oracle,
                       None if slack is None else f32_slack(
                           q[:CROSS_SINGLE], s_ids, oracle, metric))
            hold_floor(tag, rec, floor)
        else:
            if name not in fresh:
                with uncounted():
                    fresh[name] = fresh_index(name, oracle)
            set_mode(fresh[name], fields)
            with uncounted():
                f_ids = torch.as_tensor(fresh[name].search_batch(q, K)[0],
                                        device=DEVICE).long()
            f_rec = cross_recall(f_ids, d_full)
            note = f" (a fresh build: {f_rec})"
            hold_floor(tag, rec, max(floor, f_rec - 0.01), note)
        say(f"phase {tag}: single queries recall@10="
            f"{cross_recall(s_ids, d_single)}")
        timing(f"phase {tag} checked (Q={NQ} + {CROSS_SINGLE} single)",
               time.perf_counter() - t0, "s")
    del fresh, dist
    torch.cuda.empty_cache()
    return captured


def hold_global_rebuild(db, before):
    """The re-add's wide rows clipped against the global shadow's scale
    past 1% of the live rows: the search rebuilt it (a new, wider sv)."""
    shadow = db.index._scan8g_shadow()  # (..., sv, ..., clipped)
    sv1, clipped = float(shadow[2]), shadow[-1]
    say(f"phase 13a global shadow: sv {before} -> {sv1} after the re-add, "
        f"clipped since the rebuild {clipped}")
    if not (sv1 > 2 * before and clipped == 0):
        raise RuntimeError("13a: the clip rebuild of the global shadow did "
                           "not run")


def hold_shadows(db, label):
    """The churned raw-store shadows against the store requantized whole
    under their cached conditioning: the int8 rows and the bf16 rows equal,
    the offsets within 1e-5 relative (a product with the centering, whose
    summation order may differ by batch)."""
    import vector_db_torch.index.hnsw_pq as hp

    idx = db.index
    st = idx.store.state
    n, d = st.vectors.shape
    metric = idx.metric
    checks = {}
    caches = idx._caches
    if caches.scan8.value is not None:
        base8, off, sc, cvec, aux = caches.scan8.value
        r8, off_s, sc_s = hp._quantize_shadow_rows(
            st.vectors, st.norms, st.valid, cvec, aux, metric)
        checks["per_row"] = (
            torch.equal(base8[:n, :d][st.valid], r8[st.valid])
            and torch.equal(sc[:n][st.valid], sc_s[st.valid]), off[:n], off_s)
    if caches.scan8g.value is not None:
        base8, off, sv, _, cvec, aux, _ = caches.scan8g.value
        r8, off_s, _ = hp._quantize_global_rows(
            st.vectors, st.norms, st.valid, cvec, aux, sv, metric)
        checks["global"] = (torch.equal(base8[:n, :d][st.valid], r8[st.valid]),
                            off[:n], off_s)
    if caches.scan16.value is not None:
        base16, off, sc, cvec, aux = caches.scan16.value
        off_s, sc_s = hp._condition16_rows(
            st.vectors, st.norms, st.valid, cvec, aux, metric)
        checks["bf16"] = (torch.equal(base16[:n, :d][st.valid],
                                      st.vectors[st.valid].to(torch.bfloat16))
                          and torch.equal(sc[:n][st.valid], sc_s[st.valid]),
                          off[:n], off_s)
    for kind, (rows_equal, off, off_s) in checks.items():
        fin = torch.isfinite(off_s)
        same_dead = torch.equal(torch.isfinite(off), fin)
        err = float(((off - off_s).abs()[fin]
                     / (1.0 + off_s.abs()[fin])).max())
        say(f"phase 13a {label} {kind} shadow against the store requantized: "
            f"rows equal {rows_equal}, dead slots equal {same_dead}, offsets "
            f"max relative error {err}")
        if not (rows_equal and same_dead and err <= 1e-5):
            raise RuntimeError(f"13a {label}: the {kind} shadow is stale")


def hold_churned_kernels(captured):
    """Each kernel of phase 13 against its plain version at the arguments
    of its mode's last search after the last step (the live, churned
    shadows and tables); returns the largest errors."""
    from vector_db_torch.ops import kernels as kn

    errs = {}
    with uncounted():
        for label, name, _, kernel, _, _ in CROSS_MODES:
            a, kw, _ = captured[label][kernel]
            tag = f"phase 13a {label}: {kernel} on the churned shadow"
            if kernel in ("fused_int8_pool", "fused_int8g_pool",
                          "fused_packed_pool"):
                err = hold_s8_pool(tag, getattr(kn, kernel)(*a, **kw),
                                   getattr(kn, kernel + "_plain")(*a, **kw))
            elif kernel == "fused_raw_pool":
                q, base16, off, sc, w = a
                err = hold_float_pool(
                    tag, kn.fused_raw_pool(*a), kn.fused_raw_pool_plain(*a),
                    lambda s: kn.raw_pool_terms(q, base16, off, sc, s),
                    kn.pool_width(w))
            elif kernel == "fused_adc_pool":
                q, codes, cbt, norms, w = a
                err = hold_float_pool(
                    tag, kn.fused_adc_pool(*a), kn.fused_adc_pool_plain(*a),
                    lambda s: kn.adc_pool_terms(q, codes, cbt, norms, s),
                    kn.pool_width(w))
            elif kernel == "pq_decode_recon_t":
                got, want = kn.pq_decode_recon_t(*a), \
                    kn.pq_decode_recon_t_plain(*a)
                torch.cuda.synchronize()
                same = torch.equal(got, want)
                err = max_abs_err(got, want)
                say(f"{tag} out={tuple(got.shape)} bit_equal={same} "
                    f"max_abs_err={err}")
                if not same:
                    raise RuntimeError(f"{tag}: differs from plain")
            else:  # fused_ivf_pool: bit-equal on the rows the merge reads
                err = hold_ivf(tag, a[:5], *a[5:9])
            errs[kernel] = max(errs.get(kernel, 0.0), err)
    return errs


def cross_crud():
    """13a: the schedule on five databases, every mode held after every
    step; then the churned shadows and kernels.  Returns (the databases,
    the oracles, the kernels' largest errors)."""
    steps = cross_schedule()
    paths = {name: os.path.join(WORK, f"db13_{name}") for name in CROSS_DBS}
    for p in paths.values():
        shutil.rmtree(p, ignore_errors=True)
    dbs = {name: cross_db(name, p) for name, p in paths.items()}
    # ids: the schedule's, then the two races' adds (13b)
    oracles = {c: Oracle(N_CROSS + CROSS_ADD + 2 * RACE_ADDS)
               for c in ("gauss", "spectral")}
    gens = {c: torch.Generator(device=DEVICE).manual_seed(1302 + i)
            for i, c in enumerate(oracles)}
    sv_before = None
    for i, (op, ids, gauss, spec) in enumerate(steps):
        t0 = time.perf_counter()
        if op == "re-add":
            sv_before = float(dbs["gauss"].index._caches.scan8g.value[2])
        cross_apply(dbs, paths, op, ids, {"gauss": gauss,
                                          "spectral": spec})
        if op in ("add", "re-add"):
            oracles["gauss"].put(ids, gauss)
            oracles["spectral"].put(ids, spec)
        elif op == "delete":
            for o in oracles.values():
                o.drop(ids)
        live = int(oracles["gauss"].alive.sum())
        sizes = {name: db.size() for name, db in dbs.items()}
        timing(f"phase 13a step {i} {op} on five databases (live {live})",
               time.perf_counter() - t0, "s")
        if any(s != live for s in sizes.values()):
            raise RuntimeError(f"13a after {op}: sizes {sizes} != {live}")
        captured = cross_check(f"step {i} {op}", dbs, oracles, gens,
                               i == len(steps) - 1)
        if op == "re-add":
            hold_global_rebuild(dbs["gauss"], sv_before)
    for name in ("gauss", "cosine"):
        hold_shadows(dbs[name], name)
    errs = hold_churned_kernels(captured)
    return dbs, oracles, errs


def cross_threads(db, label, queries):
    """13b: 1, 2, 4 and 8 threads, four search_batch calls each, every
    answer bit-equal to one thread's."""
    import concurrent.futures

    def answer():
        return [[(r.id, r.distance) for r in row]
                for row in db.search_batch(queries, K)]

    want = answer()
    for threads in CROSS_THREADS:
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(threads) as ex:
            got = list(ex.map(lambda _: answer(), range(4 * threads)))
        took = time.perf_counter() - t0
        same = all(g == want for g in got)
        say(f"phase 13b {label}: {threads} threads x 4 search_batch "
            f"(Q={NQ}) bit-equal to one thread: {same}")
        timing(f"phase 13b {label} {threads} threads x 4 calls",
               took, "s")
        if not same:
            raise RuntimeError(f"13b {label}: {threads} threads differ")


def cross_race(db, label, oracle, gen, first_id, side_stream):
    """13b: one writer (add_batch of 1,000, 500 delete_vector, rebuild_index)
    against 4 searchers, with ``side_stream`` one of them under a CUDA
    stream of its own: every row sorted, free of -1 and of ids deleted
    before its search began; afterwards each added id first for its own
    vector."""
    import concurrent.futures

    new_ids = torch.arange(first_id, first_id + RACE_ADDS, device=DEVICE)
    new_rows = torch.randn(RACE_ADDS, DIM, device=DEVICE, generator=gen)
    live = oracle.live_ids()
    victims = live[torch.randperm(live.numel(), device=DEVICE,
                                  generator=gen)[:RACE_DELETES]]
    # queries: the victims' own rows and other live rows, barely moved
    others = live[torch.randint(0, live.numel(), (NQ - RACE_DELETES,),
                                device=DEVICE, generator=gen)]
    queries = oracle.rows[torch.cat([victims, others])] + 1e-3 * torch.randn(
        NQ, DIM, device=DEVICE, generator=gen)
    deleted, done = [], []

    def writer():
        db.add_batch(new_ids.tolist(), new_rows)
        for vid in victims.tolist():
            db.delete_vector(vid)
            deleted.append(vid)
        db.rebuild_index()
        done.append(True)
        return 0

    def searcher(own_stream):
        stream = torch.cuda.Stream() if own_stream else None
        bad = 0
        calls = 0
        with (torch.cuda.stream(stream) if own_stream
              else contextlib.nullcontext()):
            while not done or calls < 4:
                gone = set(deleted[:len(deleted)])
                for row in db.search_batch(queries, K):
                    ids = [r.id for r in row]
                    dist = [r.distance for r in row]
                    bad += (len(ids) != K or -1 in ids
                            or any(b < a for a, b in zip(dist, dist[1:]))
                            or bool(gone.intersection(ids)))
                calls += 1
        return bad, calls

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(5) as ex:
        w = ex.submit(writer)
        s = [ex.submit(searcher, side_stream and i == 0) for i in range(4)]
        w.result()
        results = [f.result() for f in s]
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    oracle.put(new_ids, new_rows)
    oracle.drop(victims)
    found = [row[0].id for row in db.search_batch(new_rows, 1)]
    first = sum(f == v for f, v in zip(found, new_ids.tolist()))
    kind = "one searcher on its own stream" if side_stream else \
        "default stream"
    say(f"phase 13b {label} race ({kind}): bad rows per searcher "
        f"{[b for b, _ in results]}, searches {[c for _, c in results]}, "
        f"added ids first for their own vector {first}/{RACE_ADDS}, "
        f"rows {db.size()}")
    timing(f"phase 13b {label} race ({kind})", took, "s")
    if any(b for b, _ in results) or first != RACE_ADDS \
            or db.size() != int(oracle.alive.sum()):
        raise RuntimeError(f"13b {label}: the race ({kind}) gave a wrong "
                           "answer")


def cross_concurrency(dbs, oracles):
    """13b on the raw scan_pallas_int8 database and the compressed +
    residual one."""
    gen = torch.Generator(device=DEVICE).manual_seed(1303)
    set_mode(dbs["gauss"].index, CROSS_MODES[0][2])
    for label, name in (("raw scan_pallas_int8", "gauss"),
                        ("compressed + residual", "resid")):
        cross_threads(dbs[name], label, cross_queries(oracles[name], gen))
    first = N_CROSS + CROSS_ADD
    for side in (False, True):
        for label, name in (("raw scan_pallas_int8", "gauss"),
                            ("compressed + residual", "resid")):
            # each database's own oracle: the two diverge in the race
            cross_race(dbs[name], label, oracles[name], gen, first, side)
        first += RACE_ADDS


CRASH_CHILD = """
import os, sys
sys.path.insert(0, {repo!r})
import torch
from vector_db_torch import HnswPqConfig, IndexType, VectorDatabase

g = torch.Generator(device="cuda").manual_seed({seed})
rows = torch.randn({n}, {dim}, device="cuda", generator=g)
more = torch.randn({adds}, {dim}, device="cuda", generator=g)
db = VectorDatabase({dim}, {cap}, IndexType.HNSWPQ, "l2", {path!r},
                     index_config=HnswPqConfig(**{cfg!r}),
                     durability={durability!r}, device="cuda")
out = sys.stdout
acked = db.add_batch(range({n}), rows)
out.write("B %d\\n" % len(acked)); out.flush()
for i in range({adds}):
    if db.add_vector({n} + i, more[i]):
        out.write("A %d\\n" % ({n} + i)); out.flush()
for vid in range(0, {n}, {n} // {deletes}):
    if db.delete_vector(vid):
        out.write("D %d\\n" % vid); out.flush()
os.kill(os.getpid(), 9)
"""


def cross_crash(counts):
    """13c: a child builds a CUDA VectorDatabase with a storage path under
    ``flush`` and one under ``fsync`` (the two at once), takes 100,000 rows
    by add_batch, 1,000 add_vector and 100 delete_vector, printing each
    acknowledged op, and SIGKILLs itself; the reopened database holds every
    acknowledged add (get_vector bit-equal, first for its own vector) and
    none of the acknowledged deletes."""
    from vector_db_torch import HnswPqConfig, IndexType, VectorDatabase

    cfg = dict(CFG, search_mode="scan_pallas_int8")
    repo = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    t0 = time.perf_counter()
    for dur in ("flush", "fsync"):
        path = os.path.join(WORK, f"db13c_{dur}")
        shutil.rmtree(path, ignore_errors=True)
        script = CRASH_CHILD.format(
            repo=repo, seed=1304, n=N_CROSS, adds=CRASH_ADDS,
            deletes=CRASH_DELETES, dim=DIM, cap=CAP_CROSS, path=path, cfg=cfg,
            durability=dur)
        procs[dur] = (path, subprocess.Popen(
            [sys.executable, "-c", script], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = {dur: (path, *p.communicate(timeout=600), p.returncode)
            for dur, (path, p) in procs.items()}
    timing("phase 13c two crash children (CUDA init, 100,000 + 1,000 adds, "
           "100 deletes, SIGKILL)", time.perf_counter() - t0, "s")
    g = torch.Generator(device=DEVICE).manual_seed(1304)
    rows = torch.randn(N_CROSS, DIM, device=DEVICE, generator=g)
    more = torch.randn(CRASH_ADDS, DIM, device=DEVICE, generator=g)
    for dur, (path, out, err, rc) in outs.items():
        if rc != -9:
            raise RuntimeError(f"13c {dur}: child exit {rc}:\n{err[-3000:]}")
        batch, adds, dels = 0, [], []
        for line in out.splitlines():
            op, val = line.split()
            if op == "B":
                batch = int(val)
            elif op == "A":
                adds.append(int(val))
            else:
                dels.append(int(val))
        want = torch.cat([rows, more])
        live = torch.zeros(N_CROSS + CRASH_ADDS, dtype=torch.bool,
                           device=DEVICE)
        live[:batch] = True
        live[torch.tensor(adds, device=DEVICE, dtype=torch.long)] = True
        live[torch.tensor(dels, device=DEVICE, dtype=torch.long)] = False
        reset_launches()
        t0 = time.perf_counter()
        db = VectorDatabase(DIM, CAP_CROSS, IndexType.HNSWPQ, "l2", path,
                            index_config=HnswPqConfig(**cfg), device=DEVICE)
        torch.cuda.synchronize()
        timing(f"phase 13c {dur} reopen on the card (checkpoint + WAL)",
               time.perf_counter() - t0, "s")
        ids = torch.nonzero(live).flatten()
        host = want.cpu().numpy()
        t0 = time.perf_counter()
        equal = all(np.array_equal(db.get_vector(v).values, host[v])
                    for v in ids.tolist())
        gone = all(db.get_vector(v) is None for v in dels)
        timing(f"phase 13c {dur} get_vector of every acknowledged add "
               f"({ids.numel()})", time.perf_counter() - t0, "s")
        first = 0
        for s in range(0, ids.numel(), 8192):
            chunk = ids[s:s + 8192]
            got = db.search_batch(want[chunk], 1)
            first += sum(row[0].id == v for row, v in zip(got, chunk.tolist()))
        say(f"phase 13c {dur}: acknowledged batch {batch}, adds {len(adds)}, "
            f"deletes {len(dels)}; reopened rows {db.size()} (want "
            f"{ids.numel()}), every add bit-equal {equal}, every delete "
            f"absent {gone}, first for its own vector {first}/{ids.numel()}")
        if not (db.size() == ids.numel() and equal and gone
                and first == ids.numel() and batch == N_CROSS):
            raise RuntimeError(f"13c {dur}: an acknowledged op was lost")
        for name, c in read_launches(f"13c {dur}", must_launch=(
                "fused_int8_pool",)).items():
            counts[name] += c
        db.close()
        shutil.rmtree(path, ignore_errors=True)


def cross_bounded_flush():
    """13d: IndexType.HNSW at 4,096 x 128 with flush_min=512 and
    flush_chunk=256, rows in batches of 256: each add_batch connects at
    most flush_chunk rows, every pending row is first for its own vector
    (the exact overlay), and the chunked graph's recall@10 is within 0.02
    of the same index's with full flushes."""
    from vector_db_torch import HnswConfig
    from vector_db_torch.index.hnsw import HnswIndex

    n, dim = N_STREAM, DIM_HNSW_SMALL
    corpus = gaussian(n, dim, 1305)
    queries = corpus[:NQ] + 0.05 * gaussian(NQ, dim, 1306)
    gt = exact_ids(corpus, queries)
    recs, worst = {}, 0
    for label, chunk in (("chunked", FLUSH_CHUNK), ("full", 0)):
        t0 = time.perf_counter()
        index = HnswIndex(dim, n, "l2", HnswConfig(
            flush_min=FLUSH_MIN, flush_chunk=chunk), device=DEVICE)
        for s in range(0, n, FLUSH_BATCH):
            before = int((index.graph.levels >= 0).sum())
            index.add_batch(range(s, s + FLUSH_BATCH),
                            corpus[s:s + FLUSH_BATCH])
            grew = int((index.graph.levels >= 0).sum()) - before
            if chunk:
                worst = max(worst, grew)
                if grew > chunk:
                    raise RuntimeError(f"13d: one add_batch connected {grew}"
                                       f" rows > flush_chunk {chunk}")
            slots = torch.as_tensor([index.store.slot_of(i)
                                     for i in range(s + FLUSH_BATCH)],
                                    device=DEVICE)
            pend = torch.nonzero(index.graph.levels[slots] < 0).flatten()
            if pend.numel():
                got, _ = index.search_batch(corpus[pend], 1)
                if not np.array_equal(got[:, 0], pend.cpu().numpy()):
                    raise RuntimeError("13d: a pending row is not first for "
                                       "its own vector")
        pending = index.stats()["pending_inserts"]
        index.flush_pending()
        took = time.perf_counter() - t0
        recs[label] = recall(index.search_batch(queries, K)[0].tolist(), gt)
        say(f"phase 13d {label} flush: largest rows connected by one "
            f"add_batch {worst if chunk else '-'}, pending before the last "
            f"flush {pending}, recall@10={recs[label]}")
        timing(f"phase 13d HNSW {dim}-d x {n} {label} flushes "
               f"(batches of {FLUSH_BATCH})", took, "s")
    hold_floor("13d chunked flush", recs["chunked"], recs["full"] - 0.02,
               " (full flushes' less 0.02)")


def phase_crosscut():
    """13: the reference's cross-cutting suites on the card (see the module
    docstring); returns the launch counts of its paths and the kernels'
    largest errors on the churned shadows."""
    counts = {name: 0 for name in KERNELS}
    t_start = time.perf_counter()
    reset_launches()
    t0 = time.perf_counter()
    dbs, oracles, errs = cross_crud()
    timing("phase 13a took", time.perf_counter() - t0, "s")
    for name, c in read_launches("13a", must_launch=tuple(
            {m[3] for m in CROSS_MODES})).items():
        counts[name] += c
    reset_launches()
    t0 = time.perf_counter()
    # the race changes the two databases apart: an oracle each
    cross_concurrency(dbs, {"gauss": oracles["gauss"],
                            "resid": oracles["gauss"].copy()})
    timing("phase 13b took", time.perf_counter() - t0, "s")
    for name, c in read_launches("13b", must_launch=(
            "fused_int8_pool", "fused_packed_pool")).items():
        counts[name] += c
    for db in dbs.values():
        db.close()
    del dbs, oracles
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cross_crash(counts)
    timing("phase 13c took", time.perf_counter() - t0, "s")
    reset_launches()
    t0 = time.perf_counter()
    cross_bounded_flush()
    timing("phase 13d took", time.perf_counter() - t0, "s")
    read_launches("13d", must_not=tuple(KERNELS))
    timing("phase 13 took", time.perf_counter() - t_start, "s")
    say(f"phase 13: kernel launches {json.dumps(counts)}")
    return counts, errs


def phase_bench():
    """14: ``vector_db_torch.bench.main([])`` in-process at its defaults
    (bench.py's flagship, 512-d x 100,000, Q=1024); its JSON line printed
    as ``bench: {...}``, its recalls held to PERF.md section 2's floors,
    pq_decode_recon_t launched and bit-equal to its plain version on the
    last decode of the bench's memory-bound loop.  Returns the launch
    counts and B3's largest error."""
    import vector_db_torch.ops.adc as adc
    from vector_db_torch import bench
    from vector_db_torch.ops import kernels as kn

    t0 = time.perf_counter()
    out = io.StringIO()
    reset_launches()
    with spying([(adc, "pq_decode_recon_t")]) as seen, \
            contextlib.redirect_stdout(out):
        result = bench.main([])
    counts = read_launches("14 bench", must_launch=("pq_decode_recon_t",),
                           must_not=tuple(n for n in KERNELS
                                          if n != "pq_decode_recon_t"))
    line = out.getvalue().strip().splitlines()[-1]
    say(f"bench: {line}")
    if json.loads(line) != result:
        raise RuntimeError("14: the bench's last line is not its result")
    hold_floor("14 bench recall_at_10", result["recall_at_10"], 0.99)
    hold_floor("14 bench adc_fast_recall_at_10",
               result["adc_fast_recall_at_10"], 0.96)
    (codes_t, cbt), _, got = seen["pq_decode_recon_t"]
    want = kn.pq_decode_recon_t_plain(codes_t, cbt)
    same = torch.equal(got, want)
    err = max_abs_err(got, want)
    say(f"phase 14 bench decode: codes_t {tuple(codes_t.shape)} cbt "
        f"{tuple(cbt.shape)} bit_equal={same} max_abs_err={err}")
    # the store's capacity is the row count rounded up to 128
    if codes_t.shape[0] != DIM // 8 or not N_FLAGSHIP <= codes_t.shape[1] < (
            N_FLAGSHIP + 128) or tuple(cbt.shape) != (DIM, 256) or not same:
        raise RuntimeError("14: pq_decode_recon_t at the bench's shape is "
                           "not bit-equal to its plain version")
    del seen, got, want
    torch.cuda.empty_cache()
    timing("phase 14 took", time.perf_counter() - t0, "s")
    return counts, err



def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a GPU",
              file=sys.stderr)
        sys.exit(1)
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    entries = {"fused_int8_pool": phase_kernel(),
               "pq_decode_recon_t": phase_decode(),
               "fused_packed_pool": phase_packed(),
               "fused_int8g_pool": phase_int8g(),
               "fused_raw_pool": phase_raw(),
               "fused_adc_pool": phase_adc(),
               "fused_ivf_pool": phase_ivf_kernel(),
               "fused_scan_topk": phase_scan_topk()}
    for name, err in phase_wide().items():
        entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], err)
    # the main path: each phase sets every launch count to 0 just before
    # its paths and reads them just after
    for counts in (phase_100k(), phase_1m(), phase_10m(), phase_membound(),
                   phase_ivf(), phase_ivf_10m(), phase_adc_modes(),
                   phase_pca(), phase_graph(), phase_indexes(),
                   phase_sharded(), phase_span()):
        for name, c in counts.items():
            entries[name]["launches"] += c
    counts, errs = phase_crosscut()
    for name, c in counts.items():
        entries[name]["launches"] += c
    for name, err in errs.items():
        entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], err)
    counts, err = phase_bench()
    for name, c in counts.items():
        entries[name]["launches"] += c
    entries["pq_decode_recon_t"]["max_abs_err"] = max(
        entries["pq_decode_recon_t"]["max_abs_err"], err)
    for name, entry in entries.items():
        if entry["launches"] == 0 and name not in NO_INDEX_CALLER:
            raise RuntimeError(f"the main path never launched {name}")
    shutil.rmtree(WORK, ignore_errors=True)
    timing("chip_smoke total", time.perf_counter() - t_start, "s")
    say(CARD)
    say(json.dumps({"kernels": list(entries.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
