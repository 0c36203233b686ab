"""The codes-only cell's pieces on the CPU: the decode kernel's roofline
reader on synthetic records, the plain ADC reference's imports, and a tiny
cell of the memory-bound configuration (6,000 x 64, 8 subspaces) that reads
``correct``, with the searches other than the stated one reading it
false."""

from __future__ import annotations

import importlib.util
import json

import pytest

from perfbench import control, run
from perfbench.tests.test_perfbench_imports import (HARNESS,
                                                   top_level_imports)
from perfbench.tests.tiny import tiny_root

CELL = "membound-512d-100k.batch1024"
#: the tiny cell's limits, from its readings on the CPU over seeds 1-3:
#: dist_err 1.70e-3-1.81e-3 (bf16 rows) against 5.9e-3-1.0e-2 with the
#: int8 re-rank; recall_at_10 0.967-0.971 against 0.889-0.911 with the
#: pool cut to 64 and 0.752-0.769 cut to 32
TINY_LIMITS = {"dist_err": {"limit": 3e-3}, "recall_at_10": {"limit": 0.94}}


def test_the_adc_reference_imports_nothing_of_the_program():
    """``reference_adc.py`` is held to what ``reference.py`` and
    ``check.py`` may import: torch, numpy and the standard library."""
    names = top_level_imports(HARNESS / "reference_adc.py")
    assert "vector_db_torch" not in names
    assert names <= {"__future__", "collections", "contextlib", "numpy",
                     "torch"}


def decode_reader():
    return run.reader(run.ROOT / "perfbench", "decode_roofline.batch")


def record(b3_s_a_call, decoded_a_call=100_096, calls=7, traced_calls=16,
           ops=None):
    if ops is None:
        ops = [["aten::topk_kernel", 1e-3],
               ["pq_decode_kernel<8>", b3_s_a_call * traced_calls]]
    return {"device_trace": {"calls": traced_calls, "busy_s": 1.0,
                             "device_ops": ops},
            "program": {"counts": {"adc.decoded_rows":
                                   decoded_a_call * calls}},
            "window": {"calls": calls},
            "config": {"index_config": {"num_subspaces": 64}},
            "shape": {"dim": 512}}


def test_decode_bound_at_the_kernel_table_shape():
    """The decode kernel's bound at its timed shape (S=64, N=524,288,
    512-d) is 0.170 ms, bytes-bound."""
    spec = importlib.util.spec_from_file_location(
        "decode_roofline",
        run.ROOT / "perfbench" / "metrics" / "decode_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.bound_s(524_288, 64, 512) == pytest.approx(0.170e-3,
                                                          abs=0.5e-6)


def test_decode_roofline_reads_the_kernel_against_its_bound():
    read = decode_reader()
    least = 100_096 * (64 + 2 * 512) / 3.35e12
    assert read(record(least)) == pytest.approx(100.0)
    assert read(record(2 * least)) == pytest.approx(50.0)


@pytest.mark.parametrize("rec", [
    record(1e-5, ops=[["aten::topk_kernel", 1e-3]]),
    record(1e-5, decoded_a_call=0),
    {**record(1e-5), "device_trace": None},
    {**record(1e-5), "program": {"counts": {}}}],
    ids=["no_decode_op", "no_columns", "no_trace", "no_counter"])
def test_decode_roofline_reads_nothing_without_its_inputs(rec):
    assert decode_reader()(rec) is None


def tiny_membound(tmp_path):
    """A cell of the memory-bound configuration at 6,000 x 64 beside the
    tiny cells, with limits of its own."""
    bench, root = tiny_root(tmp_path)
    files = root / "perfbench"
    cfg = run.load_json(files / "configs" / "membound-512d-100k.json")
    cfg.update(name="tiny-membound", dim=64, rows=6000, max_elements=6000)
    cfg["index_config"].update(num_subspaces=8, training_samples=2000)
    (files / "configs" / "tiny-membound.json").write_text(json.dumps(cfg))
    name = "tiny-membound.batch"
    (files / "checks" / f"{name}.json").write_text(json.dumps(TINY_LIMITS))
    bench["configs"].append({"name": "tiny-membound", "source": "a test",
                             "file": "perfbench/configs/tiny-membound.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": name, "config": "tiny-membound",
                               "traffic": "tiny-batch", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(name)
    return run.resolve_cell(bench, name, root)


@pytest.mark.parametrize("index_config,correct", [
    ({}, True), ({"refine_store": "int8"}, False),
    ({"adc_select_r": 32}, False)], ids=["stated", "int8_rows", "pool_32"])
def test_tiny_membound_cell(tmp_path, index_config, correct):
    cell = control.variant(tiny_membound(tmp_path), index_config)
    out = run.run_cell(cell, 1, 0.3, False, "cpu")
    assert out["correct"] is correct, out["checks"]
    assert out["failed"] == 0
    assert {"search_qps", "recall_at_10", "setup_s"} <= set(out["metrics"])


def test_tiny_membound_traced_has_no_decode_roofline_off_the_card(
        tmp_path):
    """Traced on the CPU: the per-layer metrics that read the host, and no
    decode roofline (no device trace)."""
    out = run.run_cell(tiny_membound(tmp_path), 2, 0.3, True, "cpu")
    assert out["correct"], out["checks"]
    assert "index_ms.batch" in out["metrics"]
    assert "decode_roofline.batch" not in out["metrics"]
