"""The program's own spans (``vector_db_torch.utils.stats``) in a run of
one cell, read as per-layer quantities.

    python3 -m perfbench.spans --workload <cell> --seed <n> \\
        [--seconds 10] [--stretch-seconds 3]

Set-up (``run.build_database`` and the warm-up calls) runs with the
program's tracing on, so its spans say where ``setup_s`` goes.  Tracing is
then off for a window of ``--seconds``.  The span stretch follows: tracing
on, no profiler, the plan's next calls in a closed loop for
``--stretch-seconds``.  It comes before any profiler has run in the
process: on the card, calls made after ``torch.profiler`` has run in a
process were measured slower (at Q=1 the index's host time by 6-42%),
which would read as the index's own.  Then the two profiled stretches of ``run.traced_stretches``, as in
a ``--trace 1`` run of ``run.py``, with tracing off: both record no span,
and the profiler's trace carries the program's spans as annotations all
the same, so ``idle_gaps`` labels read ``<program span>/<operator>``.
Last, ``after_profiler``: an untraced window and a span stretch of
``--stretch-seconds`` each, to show what the profiler left behind.

The last line of standard output is one JSON object: ``metrics`` (each of
``QUANTITIES`` read by ``metrics/<name>.py`` from the records below, where
it reads something), the spans a call, the stretch's and the window's mean
call, the spans the window and the profiled stretches recorded (0),
``idle_gaps``, ``span_cost_ns`` (a span's cost on this host, off and on)
and ``device``.  Standard error carries the stretch's summary
(``log_summary``).

The records (``rec["spans"]``): ``setup``, the set-up's wall (the build
and the warm-up), seconds and count by span name and the spans dropped;
``stretch``, its calls and wall, its root spans, the spans dropped, and
seconds and count by name.
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile
import time
import timeit
from pathlib import Path

import numpy as np
import torch

from . import loadgen, run

#: the quantities read from the spans; ``.batch`` / ``.q1`` as the api
QUANTITIES = ("facade_results_ms", "index_dispatch_ms", "ingest_s",
              "ingest_train_s", "shadow_build_s")
SPLIT = ("facade_results_ms", "index_dispatch_ms")
STRETCH_S = 3.0


def summarize(spans: list) -> dict:
    """Seconds and count by span name."""
    seconds, count = {}, {}
    for s in spans:
        seconds[s.name] = seconds.get(s.name, 0.0) + (s.end - s.start) * 1e-9
        count[s.name] = count.get(s.name, 0) + 1
    return {"seconds": seconds, "count": count}


def stretch(call, first_call: int, seconds: float, sync) -> tuple[dict, list]:
    """The span stretch: ``call(first_call + i)`` with tracing on until
    ``seconds`` have passed; returns (its record, its spans)."""
    from vector_db_torch.utils import stats

    stats.take_spans()
    calls = 0
    t0 = time.perf_counter()
    stats.set_tracing(True)
    try:
        while True:
            call(first_call + calls)
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
    finally:
        stats.set_tracing(False)
    wall = time.perf_counter() - t0
    spans, dropped = stats.take_spans()
    rec = {"calls": calls, "seconds_wall": wall,
           "roots": sum(1 for s in spans if s.parent is None),
           "dropped": dropped, **summarize(spans)}
    return rec, spans


def _ms(ns) -> float:
    return float(ns) * 1e-6


def log_summary(spans: list) -> dict:
    """For each span name its count and mean, p50 and p99 in ms, and the
    span tree of the slowest call, one line a span, indented by depth."""
    by_name: dict = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s.end - s.start)
    names = {}
    for name, d in sorted(by_name.items()):
        d = np.asarray(d, np.float64)
        names[name] = {"count": int(d.size), "mean_ms": _ms(d.mean()),
                       "p50_ms": _ms(np.percentile(d, 50)),
                       "p99_ms": _ms(np.percentile(d, 99))}
    roots = [s for s in spans if s.parent is None]
    if not roots:
        return {"spans": names, "slowest_call": []}
    worst = max(roots, key=lambda s: s.end - s.start)
    call = sorted((s for s in spans if s.call == worst.call),
                  key=lambda s: (s.start, -s.end))
    depth = {worst.seq: 0}
    tree = []
    for s in call:
        depth[s.seq] = 0 if s.parent is None else depth[s.parent] + 1
        note = f" ({s.note})" if s.note else ""
        tree.append(f"{'  ' * depth[s.seq]}{s.name}{note} "
                    f"{_ms(s.end - s.start):.4f} ms")
    return {"spans": names, "slowest_call": tree}


def span_cost_ns(n: int = 200_000) -> dict:
    """A span's cost on this host, in ns: ``with span(name): pass`` with
    tracing off and on, and ``timed`` around the same, less an empty
    loop (the least of five repeats each)."""
    from vector_db_torch.utils import stats

    env = {"span": stats.span, "timed": stats.timed,
           "c": stats.Counters()}

    def least(stmt):
        return min(timeit.Timer(stmt, globals=env).repeat(5, n)) / n * 1e9

    empty = least("pass")
    out = {"off": least("with span('x'): pass") - empty,
           "timed": least("with timed('t', c): pass") - empty}
    stats.take_spans()
    stats.set_tracing(True)
    try:
        out["on"] = least("with span('x'): pass") - empty
    finally:
        stats.set_tracing(False)
        stats.take_spans()
    return out


def metric_names(api: str) -> list:
    suffix = ".batch" if api == "search_batch" else ".q1"
    return [q + suffix if q in SPLIT else q for q in QUANTITIES]


def run_spans(cell: run.Cell, seed: int, seconds: float,
              stretch_s: float = STRETCH_S, device="cuda") -> dict:
    """One run of ``cell`` as the module docstring says; returns
    (the result object, the stretch's ``log_summary``) as one dict with
    the summary under ``_log``."""
    from vector_db_torch.utils import stats

    device = torch.device(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    store_dir = Path(tempfile.gettempdir()) / "perfbench-store" / cell.name
    shutil.rmtree(store_dir, ignore_errors=True)
    plan = loadgen.make_plan(cell.traffic, cell.config, seed, device)
    stats.take_spans()
    t0 = time.perf_counter()
    stats.set_tracing(True)
    try:
        system, _ = run.build_database(cell.config, seed, device, store_dir)
        warm = run.caller(system, plan)
        for i in range(plan.warmup_calls):
            warm(i)
        sync()
    finally:
        stats.set_tracing(False)
    setup_wall = time.perf_counter() - t0
    setup, setup_dropped = stats.take_spans()
    gc.collect()
    gc.freeze()
    window = run.drive(system, plan, seconds, sync)
    window_spans = len(stats.take_spans()[0])
    call = run.caller(system, plan)
    st, spans = stretch(call, window.calls, stretch_s, sync)
    first = window.calls + st["calls"]
    traced = run.traced_stretches(system, plan, first, cell.files, on_card)
    traced_spans = len(stats.take_spans()[0])
    # the same again once a profiler has run in the process
    first += 2 * plan.trace_calls
    after = run.drive(system, plan, stretch_s, sync)
    after_st, _ = stretch(call, first + after.calls, stretch_s, sync)
    gc.unfreeze()
    if cell.config["storage"] is not None:
        system.close()
    del system, warm
    gc.collect()
    shutil.rmtree(store_dir, ignore_errors=True)

    rec = {"window": {"calls": window.calls, "seconds": window.seconds},
           "spans": {"setup": {"dropped": setup_dropped,
                               "seconds_wall": setup_wall,
                               **summarize(setup)},
                     "stretch": st}}
    metrics = {}
    for name in metric_names(plan.api):
        value = run.reader(cell.files, name)(rec)
        if value is not None:
            metrics[name] = value
    dispatch = run.reader(cell.files, metric_names(plan.api)[1])
    out = {"metrics": metrics,
           "spans_per_call": len(spans) / st["calls"],
           "stretch_call_ms_mean": st["seconds_wall"] / st["calls"] * 1e3,
           "window_call_ms_mean": window.seconds / window.calls * 1e3,
           "after_profiler": {
               "window_call_ms_mean": after.seconds / after.calls * 1e3,
               "stretch_call_ms_mean":
                   after_st["seconds_wall"] / after_st["calls"] * 1e3,
               "index_dispatch_ms": dispatch({"spans": {"stretch":
                                                        after_st}})},
           "window_spans": window_spans, "traced_spans": traced_spans,
           "idle_gaps": traced["idle_gaps"],
           "records": rec["spans"],
           "device": {"kind": torch.cuda.get_device_name(device)
                      if on_card else "cpu",
                      "power_limit": run.power_limit() if on_card else None},
           "_log": log_summary(spans)}
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python3 -m perfbench.spans",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0,
                   help="the untraced window")
    p.add_argument("--stretch-seconds", type=float, default=STRETCH_S)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        bench = run.load_json(run.ROOT / "BENCHMARK.json")
        cell = run.resolve_cell(bench, args.workload)
        run.require_cards(cell.chips)
        torch.set_num_threads(2)
        out = run_spans(cell, args.seed, args.seconds, args.stretch_seconds)
        out["span_cost_ns"] = span_cost_ns()
    except (run.RunError, OSError, KeyError, ValueError) as e:
        run.log(f"perfbench spans: {type(e).__name__}: {e}")
        return 2
    run.log("perfbench spans:", json.dumps(out.pop("_log")))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
