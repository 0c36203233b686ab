"""The port's flagship benchmark (``vector_db_torch/bench.py``) on the CPU,
at a scaled configuration (4,096 x 64-d rows, 8 subspaces, Q=64).

Its JSON line carries ``bench.py``'s keys (read from that file's source)
plus the port's own; its exact scan returns the reference's ids on the same
seeded numpy rows, apart from exact distance ties (distances within rtol
1e-5: f32 sums in another order); with the reference's trained state
carried across, its memory-bound recall is at least the reference's.  The
ground-truth cache reads only its own draw's file; ``--device cuda``
without CUDA fails; nothing touches ``BENCH_LAST_GOOD.json``.
"""

import ast
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from vector_db_tpu.api.config import HnswPqConfig as RefConfig  # noqa: E402
from vector_db_tpu.index import hnsw_pq as ref_hp  # noqa: E402
from vector_db_torch import bench  # noqa: E402
from vector_db_torch.index.hnsw_pq import HnswPqIndex  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DIM, NQ, K = 4096, 64, 64, 10
ARGV = ["--device", "cpu", "--n", str(N), "--dim", str(DIM), "--nq", str(NQ),
        "--reps", "2"]
OWN_KEYS = {"index_qps", "adc_fast_index_qps", "db_qps", "device"}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _full_f32_matmuls():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_float32_matmul_precision(before)


def reference_keys() -> list:
    """The keys of the JSON line bench.py prints (``json.dumps({...})``)."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "dumps" and node.args and isinstance(node.args[0],
                                                        ast.Dict):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("bench.py prints no json.dumps({...}) line")


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One CPU run of the command line: (result, its stdout lines, the gt
    directory, BENCH_LAST_GOOD.json's digest before the run)."""
    last_good = os.path.join(ROOT, "BENCH_LAST_GOOD.json")
    before = _digest(last_good) if os.path.exists(last_good) else None
    gt_dir = str(tmp_path_factory.mktemp("gt"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = bench.main(ARGV + ["--gt-dir", gt_dir])
    return result, out.getvalue().strip().splitlines(), gt_dir, before


def test_line_carries_the_reference_keys(run):
    result, lines, _, _ = run
    keys = reference_keys()
    assert len(keys) == 11 and keys[0] == "metric"
    last = json.loads(lines[-1])
    assert last == result
    assert set(keys) | OWN_KEYS == set(last)
    assert last["metric"] == "hnswpq_flagship_batched_qps_512d_100k_k10"
    assert last["unit"] == "QPS" and last["device"] == "cpu"
    assert last["baseline_recall_at_10"] == 0.976
    for key in ("value", "build_seconds", "q1_latency_ms", "adc_fast_qps",
                "index_qps", "adc_fast_index_qps", "db_qps"):
        assert np.isfinite(last[key]) and last[key] > 0, key
    assert last["vs_baseline"] == pytest.approx(last["value"] / 2391.0)


def test_recalls(run):
    result = run[0]
    assert result["recall_at_10"] >= 0.99  # exact
    assert result["adc_fast_recall_at_10"] >= 0.96


def test_bench_last_good_untouched(run):
    _, _, gt_dir, before = run
    last_good = os.path.join(ROOT, "BENCH_LAST_GOOD.json")
    after = _digest(last_good) if os.path.exists(last_good) else None
    assert after == before
    assert sorted(os.listdir(gt_dir)) == sorted(
        f for f in os.listdir(gt_dir) if f.startswith("vector_db_torch_gt_"))
    assert len(os.listdir(gt_dir)) == 2  # gaussian and spectral
    with open(bench.__file__) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.add(node.module.split(".")[0])
    assert not imported & {"jax", "vector_db_tpu", "bench", "benchmarks"}
    assert "BENCH_LAST_GOOD" not in ast.unparse(tree)


def _rows(spectral):
    r = np.random.default_rng(42)
    rows = r.standard_normal((N, DIM)).astype(np.float32)
    queries = r.standard_normal((NQ, DIM)).astype(np.float32)
    if spectral:
        scale = ((np.arange(DIM) + 1.0) ** -0.5).astype(np.float32)
        rows, queries = rows * scale, queries * scale
    return rows, queries


def _exact(rows, queries, k):
    d = ((queries.astype(np.float64)[:, None, :]
          - rows.astype(np.float64)[None, :, :]) ** 2).sum(-1)
    return d, np.argsort(d, axis=1, kind="stable")[:, :k]


def _equal_but_ties(got, want, d64):
    """got == want, except where the two ids at a rank are tied in exact
    (float64) distance."""
    assert got.shape == want.shape
    for qi, j in zip(*np.nonzero(got != want)):
        assert d64[qi, got[qi, j]] == pytest.approx(d64[qi, want[qi, j]],
                                                    rel=1e-6)


def _ref_config(port_cfg):
    return RefConfig(**{f: getattr(port_cfg, f) for f in (
        "num_subspaces", "training_samples", "search_mode", "adc_pool",
        "adc_select_r", "refine_store")})


def test_exact_scan_matches_reference():
    rows, queries = _rows(False)
    d64, _ = _exact(rows, queries, 16)
    cfg = bench.flagship_config(DIM)
    assert cfg.num_subspaces == 8
    ref = ref_hp.HnswPqIndex(DIM, N, "l2", _ref_config(cfg))
    ref.bulk_load(range(N), jnp.asarray(rows))
    port, _ = bench.build_index(torch.from_numpy(rows), cfg)
    assert port.resolve_mode(N) == ref_hp._auto_scan_mode(False, N) \
        == "scan_exact"

    st = ref.store.state
    blk = ref._f32_scan_block(N, NQ)
    assert blk == port._f32_scan_block(port.store.capacity, NQ)
    want_d, want = ref_hp.exact_scan_search(
        jnp.asarray(queries), st.vectors, st.norms, st.valid, st.ids, 16,
        "l2", blk, ref.config.scan_recall_target)
    got_d, got = bench.exact_scan(port, NQ)(torch.from_numpy(queries))
    want, want_d = np.asarray(want), np.asarray(want_d)
    got, got_d = got.numpy(), got_d.numpy()
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-4)
    _equal_but_ties(got, want, d64)
    _equal_but_ties(port.search_batch(queries, K)[0],
                    ref.search_batch(queries, K)[0], d64)


def test_membound_recall_at_least_reference():
    rows, queries = _rows(True)
    _, gt = _exact(rows, queries, K)
    cfg = bench.membound_config(DIM)
    ref = ref_hp.HnswPqIndex(DIM, N, "l2", _ref_config(cfg))
    ref.bulk_load(range(N), jnp.asarray(rows))
    port = HnswPqIndex(DIM, N, "l2", cfg, device="cpu")
    port.load_state_arrays(ref.state_arrays())
    assert port.resolve_mode(N) == ref.config.search_mode == "adc_fast"
    r_ref = bench.recall_at(ref.search_batch(queries, K)[0], gt)
    r_port = bench.recall_at(port.search_batch(queries, K)[0], gt)
    _, loop_ids = bench.membound_scan(port)(torch.from_numpy(queries))
    r_loop = bench.recall_at(loop_ids.numpy(), gt)
    print(f"memory-bound recall@10 reference {r_ref} port {r_port} "
          f"bench loop {r_loop}")
    assert r_ref >= 0.9
    assert r_port >= r_ref and r_loop >= r_ref


def test_ground_truth_cache_reads_only_its_own_draw(tmp_path):
    rows, queries = bench.make_corpus("cpu", 600, 16, 8)
    gt_dir = str(tmp_path)
    path = bench.gt_path(gt_dir, "gaussian", rows, queries, K)
    name = os.path.basename(path)
    assert name.startswith("vector_db_torch_gt_gaussian_16_600_8_10_")
    assert "_seeds42-7_cpu_" in name
    assert name != "bench_gt_gaussian_16_600_8_10.npy"  # bench.py's name
    valid = torch.ones(600, dtype=torch.bool)
    want = bench.blocked_knn(queries, rows, valid, K)[1].numpy()
    # another draw (other seeds, another device type or other rows) has
    # another name: poisoned files under those names are never read
    other_rows, other_q = bench.make_corpus("cpu", 600, 16, 8, spectral=True)
    poisoned = [path.replace("_seeds42-7_", "_seeds1-2_"),
                path.replace("_cpu_", "_cuda_"),
                bench.gt_path(gt_dir, "gaussian", other_rows, other_q, K)]
    assert len(set(poisoned) | {path}) == 4
    for p in poisoned:
        np.save(p, np.zeros((8, K), np.int32))
    np.testing.assert_array_equal(
        bench.ground_truth(rows, queries, K, gt_dir, "gaussian"), want)
    # a truncated file (a killed run) and a misshapen one are recomputed
    with open(path, "rb") as f:
        whole = f.read()
    for broken in (whole[:len(whole) // 2], None):
        if broken is None:
            np.save(path, np.zeros((8, K + 1), np.int32))
        else:
            with open(path, "wb") as f:
                f.write(broken)
        np.testing.assert_array_equal(
            bench.ground_truth(rows, queries, K, gt_dir, "gaussian"), want)
        np.testing.assert_array_equal(np.load(path), want)
    for p in poisoned:
        np.testing.assert_array_equal(np.load(p), 0)
    assert not [f for f in os.listdir(gt_dir) if ".tmp." in f]


def test_cuda_without_cuda_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    proc = subprocess.run(
        [sys.executable, "-m", "vector_db_torch.bench", "--device", "cuda",
         "--n", "512", "--dim", "16", "--nq", "8", "--reps", "1",
         "--gt-dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert "{" not in proc.stdout
    assert os.listdir(tmp_path) == []
