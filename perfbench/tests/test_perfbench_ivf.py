"""The cluster-pruned cell's pieces on the CPU: the cluster scan's roofline
reader on synthetic records and its bound at the cell's shape, and a tiny
cell of the SIFT1M configuration (6,000 x 64, 8 clusters, 4 probed) that
reads ``correct``, with fewer probes reading it false."""

from __future__ import annotations

import importlib.util
import json

import pytest

from perfbench import control, run
from perfbench.tests.tiny import tiny_root

CELL = "sift-128d-1m-ivf.batch1024"
#: the tiny cell's limits, from its readings on the CPU over seeds 1-3:
#: dist_err 9.9e-7-1.03e-6 (the f32 refine) against 1.05e-3-1.27e-3 from
#: the control (TF32); recall_at_10 0.974-0.980 against 0.832-0.852 with
#: nprobe 2
TINY_LIMITS = {"dist_err": {"limit": 1e-5}, "recall_at_10": {"limit": 0.92}}


def ivf_module():
    spec = importlib.util.spec_from_file_location(
        "ivf_roofline", run.ROOT / "perfbench" / "metrics" / "ivf_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ivf_bound_at_the_cell_shape():
    """Q=1024 x nprobe 64 probes of 489 clusters at 1,000,000 x 128: the
    whole grid read once, 38.2 us, over 17.3 us of int8 operations."""
    mod = ivf_module()
    probed = round(1024 * 64 * 1_000_000 / 489)
    least, by = mod.bound(probed, 1_000_000, 128)
    assert by == "bytes"
    assert least == pytest.approx(38.2e-6, abs=0.05e-6)
    assert 2 * probed * 128 / 1979e12 == pytest.approx(17.3e-6, abs=0.05e-6)
    # one query reads its 64 clusters' rows alone
    one = round(64 * 1_000_000 / 489)
    assert mod.bound(one, 1_000_000, 128) == (one * 128 / 3.35e12, "bytes")


def ivf_reader():
    return run.reader(run.ROOT / "perfbench", "ivf_roofline.batch")


def record(b8_s_a_call, probed_a_call=134_020_450, calls=7, traced_calls=16,
           ops=None):
    if ops is None:
        ops = [["aten::topk_kernel", 1e-3],
               ["ivf_worklist_kernel", 1e-6 * traced_calls],
               ["ivf_pool_kernel<true>", b8_s_a_call * traced_calls]]
    return {"device_trace": {"calls": traced_calls, "busy_s": 1.0,
                             "device_ops": ops},
            "program": {"counts": {"ivf.probed_rows":
                                   probed_a_call * calls}},
            "window": {"calls": calls},
            "shape": {"n": 1_000_000, "dim": 128}}


def test_ivf_roofline_reads_the_kernel_against_its_bound():
    read = ivf_reader()
    least = 1_000_000 * 128 / 3.35e12
    assert read(record(least)) == pytest.approx(100.0)
    assert read(record(4 * least)) == pytest.approx(25.0)


@pytest.mark.parametrize("rec", [
    record(1e-4, ops=[["aten::topk_kernel", 1e-3],
                      ["ivf_worklist_kernel", 1e-5]]),
    record(1e-4, probed_a_call=0),
    {**record(1e-4), "device_trace": None},
    {**record(1e-4), "program": {"counts": {}}}],
    ids=["no_b8_op", "no_rows", "no_trace", "no_counter"])
def test_ivf_roofline_reads_nothing_without_its_inputs(rec):
    assert ivf_reader()(rec) is None


def tiny_ivf(tmp_path):
    """A cell of the SIFT1M configuration at 6,000 x 64 beside the tiny
    cells, with limits of its own."""
    bench, root = tiny_root(tmp_path)
    files = root / "perfbench"
    cfg = run.load_json(files / "configs" / "sift-128d-1m-ivf.json")
    cfg.update(name="tiny-ivf", dim=64, rows=6000, max_elements=6000)
    cfg["index_config"].update(num_subspaces=8, training_samples=2000,
                               nprobe=4)
    (files / "configs" / "tiny-ivf.json").write_text(json.dumps(cfg))
    name = "tiny-ivf.batch"
    (files / "checks" / f"{name}.json").write_text(json.dumps(TINY_LIMITS))
    bench["configs"].append({"name": "tiny-ivf", "source": "a test",
                             "file": "perfbench/configs/tiny-ivf.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": name, "config": "tiny-ivf",
                               "traffic": "tiny-batch", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(name)
    return run.resolve_cell(bench, name, root)


@pytest.mark.parametrize("index_config,correct", [
    ({}, True), ({"nprobe": 2}, False)], ids=["stated", "nprobe_2"])
def test_tiny_ivf_cell(tmp_path, index_config, correct):
    cell = control.variant(tiny_ivf(tmp_path), index_config)
    out = run.run_cell(cell, 1, 0.3, False, "cpu")
    assert out["correct"] is correct, out["checks"]
    assert out["failed"] == 0
    assert {"search_qps", "recall_at_10", "setup_s"} <= set(out["metrics"])


def test_tiny_ivf_control_reads_false(tmp_path):
    out = run.run_cell(tiny_ivf(tmp_path), 1, 0.3, False, "cpu",
                       system_kind="control")
    assert out["correct"] is False, out["checks"]


def test_tiny_ivf_traced_has_no_ivf_roofline_off_the_card(tmp_path):
    """Traced on the CPU: the per-layer metrics that read the host, and no
    cluster scan roofline (no device trace)."""
    out = run.run_cell(tiny_ivf(tmp_path), 2, 0.3, True, "cpu")
    assert out["correct"], out["checks"]
    assert "index_ms.batch" in out["metrics"]
    assert "ivf_roofline.batch" not in out["metrics"]
