"""The device trace of a traced run: ``torch.profiler`` over a bounded
stretch of calls, read from its Chrome trace.

Two stretches follow the window.  The first traces the device alone
(``ProfilerActivity.CUDA``), so the host runs at nearly its untraced
speed: the device's busy time (the union of its kernels, copies and sets),
its launches, its operations by time, and the kernel names the launch
check compares with the program's counters.  The second also traces the
host's operators and the harness's spans (``record_function``), and labels
each idle stretch of the device with what the host was doing in its
middle: ``<span>/<operator>``, where ``python`` stands for no operator (the
host in Python code, such as the facade building its results) and
``loop`` for no span (the harness between calls).

The trace goes to a file under ``tmpdir``, is read, and is deleted.
"""

from __future__ import annotations

import json
import os
import re
import time
import warnings
from typing import Callable, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "perfbench.stretch"
TOP = 10


def profile(run_calls: Callable[[], None], with_host: bool, tmpdir: str,
            on_card: bool = True) -> tuple[list, float]:
    """(Chrome trace events, wall seconds) of ``run_calls()`` under the
    profiler; the wall is taken between two synchronizations inside the
    profiled section.  Off the card (a CPU rehearsal) only the host is
    traced."""
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CUDA] if on_card else []
    if with_host or not on_card:
        acts.insert(0, ProfilerActivity.CPU)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    prof = torch.profiler.profile(activities=acts)
    with warnings.catch_warnings():   # one profile a stretch: no cycles
        warnings.filterwarnings("ignore", "Profiler clears events")
        prof.start()
    try:
        sync()
        t0 = time.perf_counter()
        with record_function(STRETCH):
            run_calls()
        sync()
        wall = time.perf_counter() - t0
    finally:
        prof.stop()
    path = os.path.join(tmpdir, f"perfbench_trace_{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        if os.path.exists(path):
            os.remove(path)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") == "X"], wall


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without its return type and argument list (cut at
    the first "(" outside its template arguments), at most ``limit``
    characters."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:limit]


def device_events(events: list) -> list:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def union_seconds(intervals: list) -> float:
    """Length of the union of [start, end) intervals in microseconds, in
    seconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def device_summary(events: list, wall_s: float, calls: int) -> dict:
    """What the device-only stretch shows: busy and window seconds,
    kernel launches and names, and the device operations by time."""
    dev = device_events(events)
    by_name: dict = {}
    for e in dev:
        key = short_name(e["name"]) if e["cat"] == "kernel" else e["name"]
        by_name[key] = by_name.get(key, 0.0) + e["dur"] * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    kernels = [e["name"] for e in dev if e["cat"] == "kernel"]
    return {
        "calls": calls,
        "window_s": wall_s,
        "busy_s": union_seconds([(e["ts"], e["ts"] + e["dur"]) for e in dev]),
        "launches": len(kernels),
        "kernel_names": kernels,
        "device_ops": [[name, s] for name, s in ops],
    }


def _innermost(intervals: list, points: list) -> list:
    """For each point (ascending), the innermost of the nested [start,
    end, label] intervals that holds it, or None."""
    evs = sorted(intervals, key=lambda x: (x[0], -x[1]))
    out, stack, j = [], [], 0
    for p in points:
        while j < len(evs) and evs[j][0] <= p:
            while stack and stack[-1][1] <= evs[j][0]:
                stack.pop()
            stack.append(evs[j])
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def idle_gaps(events: list) -> list:
    """The device's idle time inside the stretch, summed by what the host
    was doing in the middle of each idle stretch: [[label, seconds]], the
    ten largest first."""
    stretch = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == STRETCH]
    if not stretch:
        return []
    s0 = stretch[0]["ts"]
    s1 = s0 + stretch[0]["dur"]
    tid = stretch[0].get("tid")
    busy = sorted((max(e["ts"], s0), min(e["ts"] + e["dur"], s1))
                  for e in device_events(events)
                  if e["ts"] < s1 and e["ts"] + e["dur"] > s0)
    gaps, cur = [], s0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if s1 > cur:
        gaps.append((cur, s1))
    host = [e for e in events if e.get("tid") == tid]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
             if e.get("cat") == "user_annotation" and e["name"] != STRETCH]
    ops = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
           if e.get("cat") == "cpu_op"]
    mids = [(a + b) / 2 for a, b in gaps]
    span_at, op_at = _innermost(spans, mids), _innermost(ops, mids)
    by_label: dict = {}
    for (a, b), span, op in zip(gaps, span_at, op_at):
        label = f"{span or 'loop'}/{op or 'python'}"
        by_label[label] = by_label.get(label, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in
            sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]]


def launch_problems(kernel_names: list, counted: dict,
                    device_names: dict) -> list:
    """Where the profiler saw fewer launches of a hand-written kernel than
    the program's counters counted over the same calls.  ``counted``:
    function -> launches counted in the stretch; ``device_names``:
    function -> the names its kernels carry in the trace (functions that
    share names are summed)."""
    problems, groups = [], {}
    for fn, n in counted.items():
        if n <= 0:
            continue
        names: Optional[list] = device_names.get(fn)
        if not names:
            problems.append(f"{fn}: {n} launches counted, and no "
                            f"kernels/{fn}.json names its device kernels")
            continue
        key = tuple(sorted(names))
        groups[key] = groups.get(key, 0) + n
    for names, n in groups.items():
        pat = re.compile(r"(?<![A-Za-z0-9_])(?:"
                         + "|".join(map(re.escape, names)) + r")\b")
        seen = sum(1 for k in kernel_names if pat.search(k))
        if seen < n:
            problems.append(f"{'/'.join(names)}: the profiler saw {seen} "
                            f"launches, the counters counted {n}")
    return problems
