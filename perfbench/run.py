"""One run of one cell of ``BENCHMARK.json`` on the card.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up builds a ``vector_db_torch.VectorDatabase`` through its Builder
from ``configs/<config>.json``, draws the rows on the card from the seed
(``data.py``) and ingests them, draws the traffic's query pool
(``loadgen.py``), and makes the traffic's warm-up calls on the window's own
shapes.  The window then drives the facade for ``--seconds`` in a closed
loop of one client, timing each call from the caller's side and keeping the
answers of the calls the plan marks.  With ``--trace 1`` two profiled
stretches of ``trace_calls`` calls follow (``trace.py``).  Then the
program's state is freed, the rows are drawn again, and the kept answers
are compared with the plain reference (``check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` (queries sent in the window), ``failed`` (checked answers
missing), ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones, each read from the run's records by
``metrics/<name>.py``), ``device`` and, traced, ``breakdown``; last,
``checks``: each compared number beside its limit, which are also the last
lines of standard error.  A machine without enough CUDA cards, a module of
JAX or of the JAX package loaded in the process, an end-to-end metric
that a cell cannot read, or a traced stretch in which the profiler saw
fewer launches of a hand-written kernel than the program counted, ends the
run with a non-zero code and no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from . import check, data, host, loadgen, reference, roofline, trace

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that may not be loaded in a run
BANNED = ("jax", "jaxlib", "flax", "vector_db_tpu")


class RunError(RuntimeError):
    """A run that may print no result."""


# ----------------------------------------------------------- the cell's files
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list        # the BENCHMARK.json entries this cell reports
    per_layer: list
    files: Path             # the harness folder the cell's files are in


def resolve_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the benchmark ``bench`` (parsed
    ``BENCHMARK.json`` at ``root``), with its files found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    files = root / bench["paths"][0]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(name=name, chips=w["chips"], config=load_json(root / conf["file"]),
                traffic=load_json(files / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(files / "checks" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer, files=files)


def reader(files: Path, metric: str) -> Callable[[dict], Optional[float]]:
    """``read(rec)`` of ``metrics/<metric>.py``, or else of the file named
    by the metric's name up to its first dot: one reader serves a quantity
    that ``BENCHMARK.json`` splits by the end-to-end metric it moves
    (``device_idle_pct.batch`` and ``device_idle_pct.q1`` both read
    ``metrics/device_idle_pct.py``); its ``workloads`` pick the cells."""
    path = files / "metrics" / f"{metric}.py"
    if not path.exists():
        path = files / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_names(files: Path) -> dict:
    """function -> the device names of its kernels (``kernels/*.json``)."""
    return {p.stem: load_json(p)["device_names"]
            for p in sorted((files / "kernels").glob("*.json"))}


# -------------------------------------------------------------- the system
def build_database(config: dict, seed: int, device, store_dir: Path):
    """The configuration's ``VectorDatabase`` with its rows ingested;
    returns (database, fingerprint of the rows).

    The Builder gets the configuration's dimension, capacity, index type,
    metric and index config, then each of ``builder``'s calls in order
    (``{"call": "with_compression", "class": "CompressionConfig",
    "kwargs": {...}}`` hands the method an instance of that class of
    ``vector_db_torch.api.config``; ``"arg"`` a plain value), and, where
    ``storage`` is not null, the storage path ``store_dir`` and
    ``storage["durability"]``.  ``ingest["method"]`` is ``bulk_load`` (one
    call with every row), ``bulk_load_stream`` (chunks of
    ``ingest["chunk_rows"]``, drawn one at a time) or ``add_batch``
    (chunks of ``ingest["chunk_rows"]``, then ``rebuild_index``)."""
    from vector_db_torch import IndexType, VectorDatabase
    from vector_db_torch.api import config as vcfg

    b = (VectorDatabase.builder().with_dimension(config["dim"])
         .with_max_elements(config["max_elements"])
         .with_index_type(IndexType(config["index_type"]))
         .with_metric(config["metric"]).with_device(device)
         .with_index_config(getattr(vcfg, config["index_config_class"])(
             **config["index_config"])))
    for c in config.get("builder", []):
        arg = (getattr(vcfg, c["class"])(**c.get("kwargs", {}))
               if "class" in c else c["arg"])
        b = getattr(b, c["call"])(arg)
    if config["storage"] is not None:
        b = b.with_storage_path(str(store_dir)).with_durability(
            config["storage"]["durability"])
    db = b.build()

    ingest, n = config["ingest"], config["rows"]
    method = ingest["method"]
    if method == "bulk_load":
        rows = data.draw_rows(config, seed, device)
        fp = data.fingerprint(rows)
        accepted = len(db.bulk_load(np.arange(n), rows))
        del rows
    elif method in ("bulk_load_stream", "add_batch"):
        fps = []

        def chunks():
            for a, chunk in data.row_chunks(config, seed, device,
                                            ingest["chunk_rows"]):
                fps.append(data.fingerprint(chunk))
                yield np.arange(a, a + chunk.shape[0]), chunk

        if method == "bulk_load_stream":
            accepted = db.bulk_load_stream(chunks())
        else:
            accepted = sum(len(db.add_batch(ids, chunk))
                           for ids, chunk in chunks())
            db.rebuild_index()
        fp = tuple(map(sum, zip(*fps)))
    else:
        raise RunError(f"unknown ingest method {method!r}")
    if accepted != n:
        raise RunError(f"{method} accepted {accepted} of {n} rows")
    return db, fp


def launch_counts() -> dict:
    """The program's launch counter of each hand-written kernel."""
    from vector_db_torch.ops import kernels

    return {name: fn.launches for name, fn in vars(kernels).items()
            if callable(fn) and isinstance(getattr(fn, "launches", None), int)}


# --------------------------------------------------------------- the window
@dataclasses.dataclass
class Window:
    calls: int
    queries: int
    seconds: float
    call_s: np.ndarray      # each call's wall time, from the caller's side
    kept: list              # check.answer_arrays of the checked calls


def caller(system, plan: loadgen.Plan, span: Optional[str] = None):
    """call(i): the plan's call i against ``system``; returns its answers
    as a list (one answer list a query)."""
    fn = system.search_batch if plan.api == "search_batch" else system.search
    single = plan.api == "search"

    def call(i: int):
        arg = plan.argument(plan.batch_of(i))
        if span is None:
            ans = fn(arg, plan.k)
        else:
            with torch.profiler.record_function(span):
                ans = fn(arg, plan.k)
        return [ans] if single else ans
    return call


def drive(system, plan: loadgen.Plan, seconds: float, sync: Callable) -> Window:
    """The measured window: calls until ``seconds`` have passed since its
    start; the window ends with the last call's answer."""
    call = caller(system, plan)
    call_s, kept = [], []
    i = 0
    perf = time.perf_counter
    t_start = perf()
    t_stop = t_start + seconds
    while True:
        t0 = perf()
        ans = call(i)
        t1 = perf()
        call_s.append(t1 - t0)
        if plan.checked(i):
            kept.append(check.answer_arrays(
                plan.query_ids(plan.batch_of(i)), ans, plan.k))
        i += 1
        if t1 >= t_stop:
            break
    sync()
    return Window(calls=i, queries=i * plan.batch,
                  seconds=perf() - t_start, call_s=np.asarray(call_s),
                  kept=kept)


def program_delta(before: dict, after: dict) -> dict:
    return {kind: {k: v - before.get(kind, {}).get(k, 0)
                   for k, v in after.get(kind, {}).items()}
            for kind in ("seconds", "counts")}


def traced_stretches(system, plan: loadgen.Plan, first_call: int,
                     files: Path, on_card: bool) -> dict:
    """The two profiled stretches after the window (see ``trace.py``):
    the device-only summary, the idle gaps, and the launch check."""
    with tempfile.TemporaryDirectory(prefix="perfbench_") as tmpdir:
        return _stretches(system, plan, first_call, files, on_card, tmpdir)


def _stretches(system, plan, first_call, files, on_card, tmpdir) -> dict:
    span = f"db.{plan.api}"
    call = caller(system, plan, span)
    n = plan.trace_calls
    # CUPTI's start-up, outside both stretches
    trace.profile(lambda: call(first_call), False, tmpdir, on_card)
    before = launch_counts()
    events, wall = trace.profile(
        lambda: [call(first_call + j) for j in range(n)], False, tmpdir,
        on_card)
    after = launch_counts()
    summary = trace.device_summary(events, wall, n)
    counted = {k: after[k] - before.get(k, 0) for k in after}
    problems = trace.launch_problems(summary["kernel_names"], counted,
                                     kernel_names(files))
    if problems:
        raise RunError("launch check: " + "; ".join(problems))
    host_events, _ = trace.profile(
        lambda: [call(first_call + n + j) for j in range(n)], True, tmpdir,
        on_card)
    summary["idle_gaps"] = trace.idle_gaps(host_events)
    summary["launches_counted"] = {k: v for k, v in counted.items() if v}
    del summary["kernel_names"]
    return summary


# ------------------------------------------------------------------ the run
def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device="cuda", setup_t0: Optional[float] = None,
             system_kind: str = "program") -> dict:
    """One run of ``cell``; returns the result line's object.  With
    ``system_kind="control"`` the reference in lower precision
    (``reference.LowerPrecisionSearch``) stands in the program's place."""
    setup_t0 = time.perf_counter() if setup_t0 is None else setup_t0
    device = torch.device(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    config, traffic = cell.config, cell.traffic
    # a storage path of the run's own, under its TMPDIR
    store_dir = Path(tempfile.gettempdir()) / "perfbench-store" / cell.name
    plan = loadgen.make_plan(traffic, config, seed, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    if system_kind == "control":
        rows = data.draw_rows(config, seed, device)
        fp = data.fingerprint(rows)
        system = reference.LowerPrecisionSearch(rows)
        del rows
    else:
        shutil.rmtree(store_dir, ignore_errors=True)
        system, fp = build_database(config, seed, device, store_dir)
    warm = caller(system, plan)
    for i in range(plan.warmup_calls):
        warm(i)
    sync()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - setup_t0

    before = system.metrics()
    probe = host.HostProbe()
    probe.start()
    window = drive(system, plan, seconds, sync)
    host_log = probe.stop()
    prog = program_delta(before, system.metrics())
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    dev_trace = None
    if traced:
        dev_trace = traced_stretches(system, plan, window.calls, cell.files,
                                     on_card)
    gc.unfreeze()

    # the reference runs once the program's state is freed
    if system_kind != "control" and config["storage"] is not None:
        system.close()
    del system, warm
    gc.collect()
    shutil.rmtree(store_dir, ignore_errors=True)
    if on_card:
        torch.cuda.empty_cache()
    rows = data.draw_rows(config, seed, device)
    if not data.same_rows(data.fingerprint(rows), fp):
        raise RunError("the rows drawn again differ from those ingested")
    numbers = check.compare(window.kept, plan.pool, rows, plan.k)
    del rows

    checks = check.verdict(numbers, cell.limits)
    rec = {
        "config": config, "traffic": traffic,
        "shape": {"n": config["rows"], "dim": config["dim"],
                  "q": plan.batch, "k": plan.k},
        "setup_s": setup_s, "peak_bytes": peak,
        "window": {"calls": window.calls, "queries": window.queries,
                   "seconds": window.seconds, "call_s": window.call_s},
        "program": prog, "checks": numbers, "device_trace": dev_trace,
        "scan_bound_s": roofline.scan_bound(config["rows"], config["dim"],
                                            plan.batch)[0],
    }
    metrics = {}
    wanted = cell.per_layer if traced else cell.end_to_end
    for m in wanted:
        value = reader(cell.files, m["name"])(rec)
        if value is None:
            if not traced and on_card:
                raise RunError(f"end-to-end metric {m['name']} has no "
                               f"reading in {cell.name}")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": peak}
    if on_card:
        dev["power_limit"] = power_limit()
    out = {"correct": all(c["holds"] for c in checks.values()),
           "attempted": window.queries,
           "failed": numbers["missing"],
           "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = dev_trace["busy_s"]
        dev["window_s"] = dev_trace["window_s"]
        out["breakdown"] = {"device_ops": dev_trace["device_ops"],
                            "idle_gaps": dev_trace["idle_gaps"]}
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    quarters = [q for q in np.array_split(window.call_s, 4) if q.size]
    out["_log"] = {"setup_s": setup_s, "calls": window.calls,
                   "window_s": window.seconds,
                   "call_ms_mean": float(window.call_s.mean()) * 1e3,
                   "call_ms_median": float(np.median(window.call_s)) * 1e3,
                   "call_ms_p95": float(np.percentile(window.call_s, 95))
                   * 1e3,
                   "call_ms_by_quarter": [float(q.mean()) * 1e3
                                          for q in quarters],
                   "call_ms_median_by_quarter": [
                       float(np.median(q)) * 1e3 for q in quarters],
                   "host": host_log,
                   "checked_answers": numbers["answers"],
                   "checked_queries": numbers["queries"],
                   "holds": {k: c["holds"] for k, c in checks.items()},
                   "device_trace": None if dev_trace is None else
                   {k: v for k, v in dev_trace.items()
                    if k not in ("device_ops", "idle_gaps")}}
    return out


def power_limit() -> str:
    """nvidia-smi's power limit of the first card, as it prints it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e.__class__.__name__})"
    return out.stdout.strip() or f"unknown (rc {out.returncode})"


def banned_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in list(modules)} & set(BANNED))


def require_cards(n: int) -> None:
    if not torch.cuda.is_available():
        raise RunError("no CUDA card: this benchmark measures the card only")
    if torch.cuda.device_count() < n:
        raise RunError(f"the cell needs {n} CUDA cards, "
                       f"{torch.cuda.device_count()} are visible")


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python3 -m perfbench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    setup_t0 = time.perf_counter()
    args = parse_args(argv)
    try:
        bench = load_json(ROOT / "BENCHMARK.json")
        cell = resolve_cell(bench, args.workload)
        require_cards(cell.chips)
        torch.set_num_threads(2)
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", setup_t0)
        banned = banned_modules()
        if banned:
            raise RunError("modules of JAX or of the JAX package are loaded: "
                           + ", ".join(banned))
    except (RunError, OSError, KeyError, ValueError) as e:
        log(f"perfbench: {type(e).__name__}: {e}")
        return 2
    log("perfbench:", json.dumps(out.pop("_log")))
    for name, c in out["checks"].items():
        rel = ">=" if name == "recall_at_10" else "<="
        log(f"check {name} {c['value']!r} {rel} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
