"""Observability: timing counters, profiler hooks, the package logger.

The counterpart of ``vector_db_tpu/utils/stats.py``:

  * `Counters` — cheap process-wide counters/timers any component can bump.
  * `timed(name)` — records the wall time of a section; on a CUDA build it
    also opens an NVTX range of the same name, so a device trace shows it.
  * `trace(path)` — a ``torch.profiler`` capture (CPU and CUDA activity)
    written as a Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time
from typing import Iterator

import torch

logger = logging.getLogger("vector_db_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    logger.addHandler(_h)
    logger.setLevel(logging.WARNING)


class Counters:
    """Thread-safe counters + accumulated timers."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts: dict[str, int] = collections.defaultdict(int)
        self.times: dict[str, float] = collections.defaultdict(float)

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counts[name] += n

    def add_time(self, name: str, seconds: float) -> None:
        with self._lock:
            self.times[name] += seconds
            self.counts[f"{name}.calls"] += 1

    def snapshot(self) -> dict:
        with self._lock:
            out: dict = {"counts": dict(self.counts), "seconds": dict(self.times)}
        means = {}
        for name, total in out["seconds"].items():
            calls = out["counts"].get(f"{name}.calls", 0)
            if calls:
                means[name] = total / calls
        out["mean_seconds"] = means
        return out

    def reset(self) -> None:
        with self._lock:
            self.counts.clear()
            self.times.clear()


#: process-wide default instance
GLOBAL = Counters()


@contextlib.contextmanager
def timed(name: str, counters: Counters = GLOBAL) -> Iterator[None]:
    """Record the host wall time of a section (asynchronous CUDA work is
    counted only as far as the section waits for it) inside an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        counters.add_time(name, time.perf_counter() - t0)
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(path: str) -> Iterator[torch.profiler.profile]:
    """Profile a section with ``torch.profiler`` and write a Chrome trace
    to ``path``::

        with stats.trace("search_trace.json") as prof:
            db.search_batch(queries, 10)
        print(prof.key_averages().table(sort_by="cuda_time_total"))
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
