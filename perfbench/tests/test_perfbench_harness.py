"""The harness's own arithmetic and its data-driven lookup, on the CPU."""

from __future__ import annotations

import gc
import hashlib
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from perfbench import check, data, loadgen, reference, roofline, run, trace
from perfbench.tests.tiny import DATA_DIRS, LIMITS, run_tiny, tiny_root


def test_every_cell_finds_its_files():
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        cell = run.resolve_cell(bench, w["name"])
        assert cell.config["name"] == w["config"]
        loadgen.validate(cell.traffic)
        assert cell.limits["dist_err"]["limit"] > 0
        rec = cell.limits["recall_at_10"]
        assert rec["upper"] < rec["limit"] < rec["lower"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(run.reader(cell.files, m["name"]))
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for d in DATA_DIRS for p in (root / "perfbench" / d).iterdir()}


def test_new_config_mix_and_metric_are_files_only(tmp_path):
    bench, root = tiny_root(tmp_path)
    before = _digests(root)
    files = root / "perfbench"
    cfg = json.loads((files / "configs" / "tiny.json").read_text())
    cfg.update(name="tiny-wide", dim=48, rows=3000, max_elements=3000)
    (files / "configs" / "tiny-wide.json").write_text(json.dumps(cfg))
    mix = json.loads((files / "traffic" / "tiny-batch.json").read_text())
    mix.update(batch=32, pool=96)
    (files / "traffic" / "tiny-b32.json").write_text(json.dumps(mix))
    (files / "metrics" / "calls_made.py").write_text(
        "def read(rec):\n    return rec['window']['calls']\n")
    (files / "checks" / "tiny-wide.b32.json").write_text(json.dumps(LIMITS))
    bench["configs"].append({"name": "tiny-wide", "source": "a test",
                             "file": "perfbench/configs/tiny-wide.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-wide.b32", "config": "tiny-wide",
                               "traffic": "tiny-b32", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "calls_made", "unit": "calls",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["tiny-wide.b32"]})
    cell = run.resolve_cell(bench, "tiny-wide.b32", root)
    out = run.run_cell(cell, 3, 0.3, False, "cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["calls_made"]["value"] > 0
    assert out["attempted"] == 32 * out["metrics"]["calls_made"]["value"]
    assert all(_digests(root)[k] == v for k, v in before.items())


@pytest.mark.parametrize("ingest,storage", [
    ({"method": "bulk_load_stream", "chunk_rows": 1000}, None),
    ({"method": "add_batch", "chunk_rows": 2500}, {"durability": "flush"})])
def test_ingest_and_storage_come_from_the_config(tmp_path, monkeypatch,
                                                 ingest, storage):
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", None)
    bench, root = tiny_root(tmp_path)
    path = root / "perfbench" / "configs" / "tiny.json"
    cfg = json.loads(path.read_text())
    cfg.update(ingest=ingest, storage=storage, builder=[
        {"call": "with_compression", "class": "CompressionConfig",
         "kwargs": {}}])
    path.write_text(json.dumps(cfg))
    cell = run.resolve_cell(bench, "tiny.batch", root)
    out = run.run_cell(cell, 2**35 + 1, 0.3, False, "cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["recall_at_10"]["value"] == 1.0
    # the storage path lived under TMPDIR and is gone after the run
    assert list((tmp_path / "tmp").rglob("*")) in ([], [
        tmp_path / "tmp" / "perfbench-store"])


def test_rows_in_chunks_are_the_rows():
    cfg = {"rows": 700, "dim": 12, "row_distribution": "spectral"}
    rows = data.draw_rows(cfg, 2**45 + 9, "cpu")
    old = data.DRAW_CHUNK
    try:
        data.DRAW_CHUNK = 256
        rows = data.draw_rows(cfg, 2**45 + 9, "cpu")
        parts = list(data.row_chunks(cfg, 2**45 + 9, "cpu", 100))
    finally:
        data.DRAW_CHUNK = old
    assert [a for a, _ in parts] == [0, 100, 200, 256, 356, 456, 512, 612]
    assert torch.equal(torch.cat([c for _, c in parts]), rows)
    fp = tuple(map(sum, zip(*(data.fingerprint(c) for _, c in parts))))
    assert data.same_rows(fp, data.fingerprint(rows))
    assert not data.same_rows(fp, data.fingerprint(rows * 1.0001))


def test_one_reader_serves_a_split_quantity(tmp_path):
    bench, root = tiny_root(tmp_path)
    files = root / "perfbench"
    rec = {"device_trace": {"busy_s": 0.002, "calls": 4, "launches": 40},
           "window": {"seconds": 1.0, "calls": 1000}}
    a = run.reader(files, "device_idle_pct.batch")(rec)
    assert a == run.reader(files, "device_idle_pct.q1")(rec) \
        == pytest.approx(50.0)
    assert run.reader(files, "launches_per_call.anything")(rec) == 10
    # a file of the full name comes first
    (files / "metrics" / "launches_per_call.q1.py").write_text(
        "def read(rec):\n    return -1\n")
    assert run.reader(files, "launches_per_call.q1")(rec) == -1


def test_p95_is_the_tail_of_every_call(tmp_path):
    bench, root = tiny_root(tmp_path)
    read = run.reader(root / "perfbench", "search_p95_ms")
    for slow, want in ((10, 9.0), (2, 1.0)):
        call_s = np.r_[np.full(100 - slow, 1e-3), np.full(slow, 9e-3)]
        rec = {"window": {"call_s": np.random.default_rng(0).permutation(
            call_s)}}
        assert read(rec) == pytest.approx(want)


@pytest.mark.parametrize("name", ["tiny.batch", "tiny.q1"])
def test_tiny_cell_runs_and_is_correct(tmp_path, name):
    out = run_tiny(tmp_path, name, seed=2**33 + 11)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["metrics"]["recall_at_10"]["value"] == 1.0
    assert list(out)[-2] == "checks"          # before the harness's log
    assert out["device"]["platform"] == "cpu"
    assert "peak_device_gib" not in out["metrics"]   # no device figure


def test_traced_run_on_the_cpu_reads_no_device_metric(tmp_path):
    out = run_tiny(tmp_path, "tiny.batch", traced=True)
    assert out["correct"]
    assert set(out["metrics"]) <= {"facade_self_ms.batch", "index_ms.batch",
                                   "device_idle_pct.batch"}
    assert out["metrics"]["index_ms.batch"]["value"] > 0
    assert "scan_roofline.batch" not in out["metrics"]
    assert out["breakdown"]["device_ops"] == []


def test_host_probe_counts_the_collector_and_cpu_time():
    from perfbench import host

    probe = host.HostProbe()
    probe.start()
    t0 = time.process_time()
    while time.process_time() - t0 < 0.05:
        pass
    gc.collect()
    out = probe.stop()
    assert out["gc_n_by_generation"][2] >= 1
    assert out["gc_s_by_generation"][2] > 0
    assert out["user_s"] + out["sys_s"] > 0 and out["wall_s"] >= 0.05
    assert probe._on_gc not in gc.callbacks


def test_same_seed_same_inputs():
    cfg = {"rows": 300, "dim": 16, "row_distribution": "spectral"}
    a, b = data.draw_rows(cfg, 2**40 + 3, "cpu"), data.draw_rows(
        cfg, 2**40 + 3, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, data.draw_rows(cfg, 2**40 + 4, "cpu"))
    assert np.array_equal(data.draw_queries(cfg, 20, 5, "cpu"),
                          data.draw_queries(cfg, 20, 5, "cpu"))


def test_reference_topk_matches_numpy_brute_force():
    g = np.random.default_rng(0)
    rows = g.standard_normal((3000, 40)).astype(np.float32)
    queries = g.standard_normal((70, 40)).astype(np.float32)
    d2 = ((queries[:, None, :].astype(np.float64)
           - rows[None, :, :].astype(np.float64)) ** 2).sum(2)
    want = np.argsort(d2, axis=1, kind="stable")[:, :10]
    ids, dist = reference.exact_topk(torch.as_tensor(queries),
                                     torch.as_tensor(rows), 10)
    assert np.array_equal(ids.numpy(), want)
    np.testing.assert_allclose(dist.numpy(),
                               np.take_along_axis(d2, want, 1), rtol=1e-12)


def test_recall_and_missing_arithmetic():
    g = np.random.default_rng(1)
    rows = torch.as_tensor(g.standard_normal((500, 8)).astype(np.float32))
    pool = g.standard_normal((4, 8)).astype(np.float32)
    ids, d2 = reference.exact_topk(torch.as_tensor(pool), rows, 10)
    R = reference.Result

    def answer(q, swap=0):
        got = ids[q].tolist()
        for j in range(swap):      # replace the last ``swap`` by far rows
            got[9 - j] = int(torch.argmax(((rows - torch.as_tensor(pool[q]))
                                           ** 2).sum(1))) - j
        true = ((rows[got] - torch.as_tensor(pool[q])) ** 2).sum(1).sqrt()
        return [R(i, float(d)) for i, d in zip(got, true)]

    kept = [check.answer_arrays(q, a, 10) for q, a in (
        ([0, 1], [answer(0), answer(1, swap=3)]),
        ([2, 3], [answer(2), answer(3)[:9]]),
        ([0], [answer(0, swap=5)]))]              # a repeat: not counted
    n = check.compare(kept, pool, rows, 10)
    assert n["recall_at_10"] == pytest.approx((10 + 7 + 10 + 9) / 40)
    assert n["missing"] == 1 and n["answers"] == 5 and n["queries"] == 4
    assert n["dist_err"] < 1e-6
    v = check.verdict(n, {"dist_err": {"limit": 1e-5},
                          "recall_at_10": {"limit": 0.95}})
    assert not v["missing"]["holds"] and not v["recall_at_10"]["holds"]
    assert v["dist_err"]["holds"]


def test_roofline_bounds_of_the_four_cells():
    cases = [((100_000, 512, 1024), 0.0530, "ops"),
             ((1_000_000, 960, 1024), 0.994, "ops"),
             ((100_000, 512, 1), 0.0153, "bytes"),
             ((1_000_000, 960, 1), 0.287, "bytes")]
    for shape, ms, by in cases:
        s, got_by = roofline.scan_bound(*shape)
        assert got_by == by
        assert s * 1e3 == pytest.approx(ms, rel=2e-3)


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def test_device_summary_union_and_idle_gaps():
    events = [_ev("user_annotation", trace.STRETCH, 0, 100),
              _ev("user_annotation", "db.search", 5, 40),
              _ev("cpu_op", "aten::copy_", 10, 5),
              _ev("kernel", "k1", 20, 10, tid=7),
              _ev("kernel", "k2", 25, 10, tid=7),
              _ev("gpu_memcpy", "Memcpy DtoH", 60, 10, tid=7)]
    s = trace.device_summary(events, 1e-4, 2)
    assert s["busy_s"] == pytest.approx(25e-6)
    assert s["launches"] == 2 and s["kernel_names"] == ["k1", "k2"]
    gaps = dict(trace.idle_gaps(events))
    # [0,20): db.search at 10 -> python (no op holds 10.0? copy_ 10-15)
    assert gaps == pytest.approx({"db.search/aten::copy_": 20e-6,
                                  "loop/python": 25e-6 + 30e-6})


def test_launch_check_compares_whole_kernel_names():
    names = ["void wg::pool_kernel<A>(x)", "void ivf_pool_kernel<B>(y)"]
    dev = {"fused_int8_pool": ["pool_kernel"],
           "fused_raw_pool": ["pool_kernel"],
           "fused_ivf_pool": ["ivf_pool_kernel"]}
    assert trace.launch_problems(names, {"fused_int8_pool": 1,
                                         "fused_ivf_pool": 1}, dev) == []
    # the ivf kernel's name does not count as a pool_kernel launch
    assert trace.launch_problems(names, {"fused_int8_pool": 1,
                                         "fused_raw_pool": 1}, dev)
    assert trace.launch_problems(names, {"unlisted_kernel": 2}, dev)


def test_banned_modules_compares_top_level_names_whole():
    assert run.banned_modules({"vector_db_torch": 1, "vector_db_torch.ops": 1,
                               "jaxtyping": 1, "flaxen": 1}) == []
    assert run.banned_modules({"jax.numpy": 1, "vector_db_tpu.api": 1}) == [
        "jax", "vector_db_tpu"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "flagship-100k.batch1024", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    """A directory with BENCHMARK.json and perfbench/ only: no program."""
    import shutil

    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        "flagship-100k.batch1024", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
