"""search_p95_ms: the 95th percentile of every call's wall time in the
window, taken from the caller's side (perf_counter around each call), in
milliseconds: the latency one client waits for, at its tail."""

import numpy as np


def read(rec):
    call_s = rec["window"]["call_s"]
    if not call_s.size:
        return None
    return float(np.percentile(call_s, 95)) * 1e3
