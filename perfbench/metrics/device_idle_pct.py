"""device_idle_pct: the share of a call's wall time in which the card is
idle, in percent: 1 - (the device time of one call, the union of every
kernel, copy and set in the device-only stretch over its calls) / (the
untraced window's time over its calls).  The window's calls and not the
stretch's: under the profiler the host runs its calls 35-45% slower, which
would read as idle time the untraced run does not have."""


def read(rec):
    t, w = rec["device_trace"], rec["window"]
    if not t or t["busy_s"] <= 0:
        return None
    return (1.0 - (t["busy_s"] / t["calls"]) / (w["seconds"] / w["calls"])) \
        * 100.0
