"""The program's spans in the harness (``spans.py``, ``metrics/`` readers
of the spans), on the CPU: a tiny run reads every quantity, the window and
the profiled stretches record no span, and the profiler's annotations
label idle stretches by the program's spans."""

from __future__ import annotations

import pytest

from perfbench import loadgen, run, spans, trace
from perfbench.tests.tiny import run_tiny, tiny_root
from vector_db_torch.utils import stats


@pytest.fixture(autouse=True)
def _tracing_off():
    stats.set_tracing(False)
    stats.take_spans()
    yield
    stats.set_tracing(False)
    stats.take_spans()


@pytest.mark.parametrize("mode", ["scan_exact", "scan_pallas_int8"])
@pytest.mark.parametrize("name", ["tiny.batch", "tiny.q1"])
def test_tiny_run_reads_every_quantity(tmp_path, name, mode):
    bench, root = tiny_root(tmp_path, search_mode=mode)
    cell = run.resolve_cell(bench, name, root)
    out = spans.run_spans(cell, 2**33 + 5, 0.3, 0.3, "cpu")
    split = ".batch" if name == "tiny.batch" else ".q1"
    want = {"facade_results_ms" + split, "index_dispatch_ms" + split,
            "ingest_s", "ingest_train_s"}
    if mode == "scan_pallas_int8":
        want.add("shadow_build_s")
    assert set(out["metrics"]) == want
    assert all(v > 0 for v in out["metrics"].values())
    assert out["window_spans"] == 0 and out["traced_spans"] == 0
    st = out["records"]["stretch"]
    assert st["roots"] == st["calls"] > 0 and st["dropped"] == 0
    per_call = 6 + (mode == "scan_pallas_int8")     # + index.refine
    assert out["spans_per_call"] == per_call
    assert out["metrics"]["ingest_s"] >= out["metrics"]["ingest_train_s"]
    log = out["_log"]
    assert log["spans"]["index.search"]["count"] == st["calls"]
    assert log["slowest_call"][0].startswith("facade.search")
    assert log["slowest_call"][1].startswith("  ")


def test_span_cost_leaves_nothing_recorded():
    cost = spans.span_cost_ns(n=2000)
    assert set(cost) == {"off", "on", "timed"}
    assert stats.take_spans() == ([], 0)
    assert stats.span("x") is stats.span("y")


def test_readers_read_nothing_without_spans(tmp_path):
    bench, root = tiny_root(tmp_path)
    files = root / "perfbench"
    full = {"setup": {"dropped": 0, "seconds": {"ingest.bulk_load": 2.0,
                                                "ingest.train": 1.0},
                      "count": {"ingest.bulk_load": 1, "ingest.train": 1}},
            "stretch": {"calls": 4, "roots": 4, "dropped": 0,
                        "seconds": {"facade.results": 0.004,
                                    "index.search": 0.02,
                                    "index.fetch": 0.012},
                        "count": {"facade.results": 4, "index.search": 4,
                                  "index.fetch": 4}}}
    read = {q: run.reader(files, q) for q in spans.QUANTITIES}
    assert read["facade_results_ms"]({"spans": full}) == pytest.approx(1.0)
    assert read["index_dispatch_ms"]({"spans": full}) == pytest.approx(2.0)
    assert read["ingest_s"]({"spans": full}) == 2.0
    assert read["ingest_train_s"]({"spans": full}) == 1.0
    assert read["shadow_build_s"]({"spans": full}) is None
    for q in spans.QUANTITIES:                      # a program without spans
        assert read[q]({"window": {}}) is None
    full["stretch"]["roots"] = 3                    # a call without its root
    full["setup"]["dropped"] = 1
    for q in spans.QUANTITIES:
        assert read[q]({"spans": full}) is None


def test_traced_run_records_no_span(tmp_path):
    out = run_tiny(tmp_path, "tiny.batch", traced=True)
    assert out["correct"]
    assert stats.take_spans() == ([], 0)


def test_idle_gaps_name_the_program_span(tmp_path):
    """The unchanged harness's host-profiled stretch: a device gap in the
    middle of a program span is labelled by it, not by the harness's."""
    bench, root = tiny_root(tmp_path)
    cell = run.resolve_cell(bench, "tiny.batch", root)
    db, _ = run.build_database(cell.config, 3, "cpu", tmp_path / "store")
    plan = loadgen.make_plan(cell.traffic, cell.config, 3, "cpu")
    call = run.caller(db, plan, "db.search_batch")
    call(0)
    events, _ = trace.profile(lambda: [call(i) for i in range(2)], True,
                              str(tmp_path), on_card=False)
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    stretch = next(e for e in ann if e["name"] == trace.STRETCH)
    for label in ("facade.results", "index.scan", "index.fetch"):
        span = next(e for e in ann if e["name"] == label)
        mid = span["ts"] + span["dur"] / 2
        # the device busy over the whole stretch but a 0.2 us hole there
        fake = [{"cat": "kernel", "name": "k", "ts": stretch["ts"],
                 "dur": mid - stretch["ts"]},
                {"cat": "kernel", "name": "k", "ts": mid + 0.2,
                 "dur": stretch["ts"] + stretch["dur"] - mid - 0.2}]
        gaps = trace.idle_gaps(events + fake)
        assert len(gaps) == 1 and gaps[0][0].split("/")[0] == label
    assert stats.take_spans() == ([], 0)
