"""Observability: counters, timers, spans, the package logger.

The counterpart of ``vector_db_tpu/utils/stats.py``, one system in one
module:

  * `Counters` — cheap process-wide counters/timers any component can bump
    (`GLOBAL`, read through ``VectorDatabase.metrics()``).  Among them the
    work a search asks of a layer, counted on the host from shapes:
    ``adc.decoded_rows`` and ``adc.refined`` (``ops/adc``), and
    ``ivf.probes``, ``ivf.probed_rows`` and ``ivf.pool_rows`` (scan_ivf's
    padded batch, ``index/hnsw_pq``).
  * `timed(name)` — always on: adds the host wall time of a section to a
    `Counters` timer and counts its calls.
  * `span(name)` — a named, nested section of the program.  Off by
    default, when it costs one call and two flag tests and returns a shared
    no-op object.  `set_tracing(True)` turns recording on for the process;
    `take_spans()` returns what was recorded and empties the buffer::

        stats.set_tracing(True)
        for q in queries:
            db.search(q, 10)
        stats.set_tracing(False)
        spans, dropped = stats.take_spans()

    Each record (`SpanRecord`) carries its call id (the sequence number of
    the root span that opened the call: ``facade.search``,
    ``facade.search_batch``, ``ingest.bulk_load``), its parent and its start
    and end by ``time.perf_counter_ns()``.  The buffer is bounded: when it
    is full the oldest record goes and `take_spans` counts it as dropped.
    While recording, a span also opens an NVTX range of its name on a CUDA
    build.  Whenever a ``torch.profiler`` is running, recording or not, a
    span opens a ``record_function`` range of its name, so the profiler's
    trace shows the program's sections on its own clock, on the thread that
    launched their kernels.

Spans the program opens: ``facade.search``, ``facade.search_batch`` (a
call's root), ``facade.results`` (building the result objects),
``index.search`` (the facade's call into the index), ``index.copy_in``
(the queries to the device and their padding), ``index.scan`` (the scan or
pool and its select), ``index.refine`` (the exact re-rank of a pool),
``index.replay`` (a padded-8 search's CUDA graph replay, which runs the
scan and the re-rank without their spans: ``index/q8graph``),
``index.fetch`` (the answers to the host), ``index.shadow`` (a scan
shadow built or refreshed, noted ``whole`` or ``incremental``; adc_fast's
decode tables, ``fast_tables``; a packed refine store of the raw rows,
``bf16_refine`` or ``int8_refine``; the scan_ivf layout built,
``ivf_layout``, or its overlay refreshed, ``ivf_overlay``),
``ingest.bulk_load`` and ``ingest.train`` (the quantizers' fitting).  The
``ingest.*`` spans wait for the device at their end while recording, so
their length is the work's and not its enqueue; spans on the search path
never wait.
"""

from __future__ import annotations

import collections
import itertools
import logging
import threading
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

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


# ------------------------------------------------------------------- spans
class SpanRecord(NamedTuple):
    """One closed span: ``seq`` its sequence number, ``call`` the sequence
    number of its root, ``parent`` its parent's (None for a root), ``start``
    and ``end`` in ``time.perf_counter_ns()`` nanoseconds, ``note`` what the
    span notes (which shadow, or ``whole`` / ``incremental``, for
    ``index.shadow``)."""

    seq: int
    name: str
    call: int
    parent: Optional[int]
    start: int
    end: int
    note: Optional[str] = None


#: records the buffer holds (~200 bytes each: ~54 MB when full)
SPAN_CAPACITY = 1 << 18

_tracing = False
_nvtx = False
_buffer: collections.deque = collections.deque(maxlen=SPAN_CAPACITY)
_dropped = 0
_buffer_lock = threading.Lock()
_seq = itertools.count()
_local = threading.local()


class _Off:
    """The span of a program that is not tracing: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _Span:
    """A recorded span (while `set_tracing(True)`)."""

    __slots__ = ("name", "wait", "note", "seq", "call", "parent", "start",
                 "_rf")

    def __init__(self, name: str, wait, note):
        self.name, self.wait, self.note = name, wait, note

    def open(self, start: int) -> None:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.seq = next(_seq)
        if stack:
            top = stack[-1]
            self.parent, self.call = top.seq, top.call
        else:
            self.parent, self.call = None, self.seq
        stack.append(self)
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        if _nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.start = start

    def close(self, end: Optional[int] = None) -> None:
        if self.wait is not None and self.wait.type == "cuda":
            torch.cuda.synchronize(self.wait)
        if end is None:
            end = time.perf_counter_ns()
        if _nvtx:
            torch.cuda.nvtx.range_pop()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        _local.stack.pop()
        _record(SpanRecord(self.seq, self.name, self.call, self.parent,
                           self.start, end, self.note))

    def __enter__(self):
        self.open(time.perf_counter_ns())
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _record(rec: SpanRecord) -> None:
    global _dropped
    with _buffer_lock:
        if len(_buffer) == _buffer.maxlen:
            _dropped += 1
        _buffer.append(rec)


def span(name: str, wait: Optional[torch.device] = None,
         note: Optional[str] = None):
    """A context manager around one section of the program, named
    ``name``.  ``wait``: a device whose queued work the span waits for at
    its end while recording (set-up spans only).  ``note``: a word the
    record carries."""
    if not _tracing:
        if _profiler._is_profiler_enabled:
            return _profiler.record_function(name)
        return _OFF
    return _Span(name, wait, note)


def set_tracing(on: bool) -> None:
    """Turn span recording on or off for the whole process."""
    global _tracing, _nvtx
    _nvtx = bool(on) and torch.cuda.is_available()
    _tracing = bool(on)


def take_spans() -> tuple[list[SpanRecord], int]:
    """(the spans recorded since the last call, oldest first; how many
    were dropped as the buffer overflowed), and empties the buffer."""
    global _dropped
    with _buffer_lock:
        out, dropped = list(_buffer), _dropped
        _buffer.clear()
        _dropped = 0
    return out, dropped


class timed:
    """Add the host wall time of a section to the timer ``name`` of
    ``counters`` (asynchronous CUDA work is counted only as far as the
    section waits for it) and count its call; always on.  With
    ``span_name`` the section is also that span, on the same clock
    reading at each end."""

    __slots__ = ("name", "counters", "span_name", "_span", "_t0")

    def __init__(self, name: str, counters: Counters = GLOBAL,
                 span_name: Optional[str] = None):
        self.name, self.counters, self.span_name = name, counters, span_name

    def __enter__(self):
        sp = _OFF if self.span_name is None else span(self.span_name)
        self._span = sp
        self._t0 = time.perf_counter_ns()
        if type(sp) is _Span:
            sp.open(self._t0)
        else:
            sp.__enter__()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        sp = self._span
        if type(sp) is _Span:
            sp.close(t1)
        else:
            sp.__exit__(*exc)
        self.counters.add_time(self.name, (t1 - self._t0) * 1e-9)
        return False
