"""What the host did during the window, for the run's log: the time the
collector paused the caller, by generation, and the process's CPU time
against the window's wall.  Neither is a metric; they tell a window that
the program made slow (collections, more work) from one on a slower host
core (the same CPU share, more time).  The machine-wide counters of
/proc/stat and the process's fault and switch counts read constant inside
the chip's sandbox, so they are not taken."""

from __future__ import annotations

import gc
import os
import time


class HostProbe:
    """``start()`` before the window and ``stop()`` after it; ``stop``
    returns the deltas."""

    def __init__(self):
        self._gc_t0 = None
        self.gc_s = [0.0, 0.0, 0.0]
        self.gc_n = [0, 0, 0]

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            g = info["generation"]
            self.gc_s[g] += time.perf_counter() - self._gc_t0
            self.gc_n[g] += 1
            self._gc_t0 = None

    def start(self) -> None:
        self._cpu = os.times()
        self._t = time.perf_counter()
        gc.callbacks.append(self._on_gc)

    def stop(self) -> dict:
        gc.callbacks.remove(self._on_gc)
        wall = time.perf_counter() - self._t
        cpu = os.times()
        return {"gc_s_by_generation": self.gc_s,
                "gc_n_by_generation": self.gc_n,
                "user_s": cpu.user - self._cpu.user,
                "sys_s": cpu.system - self._cpu.system,
                "wall_s": wall}
