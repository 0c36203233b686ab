"""The padded-8 search as one CUDA graph replay.

A search of at most eight queries runs on eight rows
(``base.pad_queries_pow2``): every ``db.search`` call, and every batch of up
to eight, runs its mode's program on the same shapes.  :class:`Q8Graphs`
captures that program in a CUDA graph (``torch.cuda.CUDAGraph``) and replays
it.  The query rows go into a pinned host buffer (pad rows zero) and from it
by one copy into the graph's static input; the graph ends in the answers'
external ids and distances, packed in one [2, 8, k] int32 tensor, which
one copy brings back into a pinned buffer; the host waits on one event.  A
replay runs the eager program's own launches, in the same order, on the same
tensors, so its answers are the eager path's, bit for bit.

The key is the program's scalars (mode, k, pool, width, metric, the
shadow's count of whole builds) and the data pointer, shape and dtype of
every tensor it reads.  A write in place is seen by the replay, which reads
the memory its launches name when it runs; a reallocation (a reload,
``bulk_load``) or a whole shadow rebuild gives a new key.  The first call under a key runs eagerly, which also loads
the kernels and warms cuBLAS; the second captures and replays; later calls
replay.  An index keeps at most :data:`MAX_GRAPHS` graphs and drops the
oldest (which frees its memory pool).

Capture runs on a side stream that waits for the caller's, in
``thread_local`` capture mode, under one lock for the process (concurrent
readers keep launching on the default stream meanwhile, which a
non-blocking side stream does not wait for).  Each graph has its own mutex,
held from filling its input to reading its output, so two callers never
share its static buffers.  A kernel launch made while capturing is tallied,
not counted (``ops/kernels.captured_launches``), and each replay adds the
tally to ``<kernel>.launches``.

Counters in ``utils/stats.GLOBAL``: ``q8graph.captures``,
``q8graph.replays``, and ``q8graph.eager``, the calls of at most eight
queries on a device that captures which ran eagerly (the first call under a
key, a mode outside the captured set, the exact fallback of an untrained
index).  Spans: ``index.copy_in`` (the pinned fill and the copy in),
``index.replay`` (the replay's enqueue), ``index.fetch`` (the copy back, the
wait and the host arrays).
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops import kernels
from ..utils.stats import GLOBAL, logger, span
from .base import host_results

#: query rows of the captured program (``pad_queries_pow2``'s least)
Q_ROWS = 8
#: graphs an index keeps; the oldest goes first
MAX_GRAPHS = 4

#: one capture at a time in the process
_CAPTURE_LOCK = threading.Lock()


class Program(NamedTuple):
    """A mode's padded-8 program: ``run(queries [8, d])`` returns (dists
    [8, k] f32, external ids [8, k] int32); ``scalars`` and ``reads`` (every
    tensor ``run`` reads) make its key."""

    run: Callable
    scalars: tuple
    reads: tuple

    def key(self) -> tuple:
        return self.scalars + tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                                    for t in self.reads)


class CudaCapturer:
    """Warms and captures programs on a side stream of its own."""

    def __init__(self, device: torch.device):
        self.device = device
        self._side: Optional[torch.cuda.Stream] = None

    def _on_side(self, fn):
        cur = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(cur)
        try:
            with torch.cuda.stream(self._side):
                return fn()
        finally:
            cur.wait_stream(self._side)

    def warm(self, program: Callable, q_in: torch.Tensor) -> None:
        """Run ``program`` once on the side stream, outside any graph (its
        cuBLAS workspace is then not allocated inside one)."""
        self._on_side(lambda: program(q_in))

    def capture(self, program: Callable, q_in: torch.Tensor):
        """(replay, out): ``program(q_in)`` captured; ``replay()`` runs it
        on the current stream and writes ``out``."""
        graph = torch.cuda.CUDAGraph()

        def captured():
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                return program(q_in)
            finally:
                graph.capture_end()
        return graph.replay, self._on_side(captured)


class _Graph:
    """One key's graph and static buffers.  ``replay`` is None until it is
    captured (and stays None if capture failed: the key then runs
    eagerly)."""

    __slots__ = ("lock", "replay", "failed", "q_in", "q_host", "q_np", "out",
                 "out_host", "done", "launches")

    def __init__(self):
        self.lock = threading.Lock()
        self.replay = None
        self.failed = False


class Q8Graphs:
    """An index's padded-8 graphs, by key.  ``capturer`` None (the CPU):
    nothing is captured and every call runs eagerly."""

    def __init__(self, device: torch.device, capturer=None):
        self.device = device
        self.capturer = capturer
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def clear(self) -> None:
        """Drop every graph (the index was rebuilt or reloaded)."""
        with self._lock:
            self._graphs.clear()

    def _lookup(self, key: tuple) -> Optional[_Graph]:
        """The graph of ``key``, or None the first time the key is seen."""
        with self._lock:
            graph = self._graphs.get(key)
            if graph is not None:
                self._graphs.move_to_end(key)
                return graph
            self._graphs[key] = _Graph()
            if len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
            return None

    def search(self, program: Program, q: torch.Tensor, k: int, k_eff: int
               ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Host (ids [Q, k], dists [Q, k]) of queries ``q`` [Q <= 8, d]
        (f32, on the host or a device) by replay, as ``to_host_results``
        shapes them; None where the call runs eagerly instead."""
        graph = self._lookup(program.key())
        if graph is None:
            return None
        with graph.lock:
            if graph.replay is None and (
                    graph.failed or not self._capture(graph, program,
                                                      q.shape[1])):
                return None
            q_n = q.shape[0]
            with span("index.copy_in"):
                if q.device.type == "cpu":
                    graph.q_np[:q_n] = q.numpy()
                    graph.q_np[q_n:] = 0.0
                    graph.q_in.copy_(graph.q_host, non_blocking=True)
                else:
                    graph.q_in[:q_n].copy_(q)
                    graph.q_in[q_n:].zero_()
            with span("index.replay"):
                graph.replay()
                for fn, n in graph.launches:
                    fn.launches += n
            GLOBAL.bump("q8graph.replays")
            with span("index.fetch"):
                graph.out_host.copy_(graph.out, non_blocking=True)
                if graph.done is not None:
                    graph.done.record()
                    graph.done.synchronize()
                out = graph.out_host.numpy()
                return host_results(q_n, k, k_eff, out[0],
                                    out[1].view(np.float32))

    def _capture(self, graph: _Graph, program: Program, dim: int) -> bool:
        """Allocate ``graph``'s buffers and capture ``program`` into it;
        False (and the key runs eagerly from then on) if capture failed."""
        pin = self.device.type == "cuda"
        graph.q_in = torch.zeros((Q_ROWS, dim), device=self.device)
        graph.q_host = torch.zeros((Q_ROWS, dim), pin_memory=pin)
        graph.q_np = graph.q_host.numpy()

        def packed(x):
            dists, ext = program.run(x)
            return torch.stack((ext.to(torch.int32),
                                dists.view(torch.int32)))
        with _CAPTURE_LOCK:
            try:
                self.capturer.warm(packed, graph.q_in)
                with kernels.captured_launches() as tally:
                    replay, out = self.capturer.capture(packed, graph.q_in)
            except RuntimeError as exc:
                # the same program ran eagerly under this key: what failed
                # is the capture, so the key keeps the eager path
                logger.warning("padded-8 graph capture failed, the search "
                               "runs eagerly: %s", exc)
                graph.failed = True
                return False
        graph.out = out
        graph.out_host = torch.empty(tuple(out.shape), dtype=out.dtype,
                                     pin_memory=pin)
        graph.done = torch.cuda.Event() if pin else None
        graph.launches = tuple(tally.items())
        graph.replay = replay
        GLOBAL.bump("q8graph.captures")
        return True


def for_device(device: torch.device) -> Q8Graphs:
    """The padded-8 graphs of an index on ``device``: captured on CUDA,
    none elsewhere."""
    return Q8Graphs(device, CudaCapturer(device)
                    if device.type == "cuda" else None)
