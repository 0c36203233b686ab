"""ivf_roofline: the cluster scan's (B8, ``fused_ivf_pool``) least time a
call over its device time a call, in percent of the published peaks.

The least time of one call, from the program's counter ``ivf.probed_rows``
(the query-row pairs the cluster scan scores at the mean fill, P) over the
window's calls: every row of a probed cluster read once at one byte a
dimension, R = min(n_live, P) rows, and every pair scored at int8's peak
rate::

    max(R * d / HBM_BYTES_S, 2 * P * d / PEAK_OPS_S["int8"])

The device time: the device-only stretch's operations whose names
``kernels/fused_ivf_pool.json`` gives, over the stretch's calls.  Nothing
off the card, without the counter (a program that does not count it), or
where the kernel is not among the stretch's operations (``trace.py`` keeps
its ten longest)."""

import json
import re
from pathlib import Path

from perfbench import roofline

KERNELS = Path(__file__).resolve().parent.parent / "kernels" \
    / "fused_ivf_pool.json"


def bound(probed_rows: float, n_live: int, d: int) -> tuple[float, str]:
    """(seconds, "bytes" or "ops"): the least time of a cluster scan that
    scores ``probed_rows`` query-row pairs over a corpus of ``n_live`` rows
    of ``d`` one-byte dimensions."""
    t_bytes = min(n_live, probed_rows) * d / roofline.HBM_BYTES_S
    t_ops = 2.0 * probed_rows * d / roofline.PEAK_OPS_S["int8"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")


def read(rec):
    t = rec["device_trace"]
    probed = rec["program"]["counts"].get("ivf.probed_rows", 0)
    if not t or not probed or not rec["window"]["calls"]:
        return None
    names = json.loads(KERNELS.read_text())["device_names"]
    pat = re.compile(r"(?<![A-Za-z0-9_])(?:"
                     + "|".join(map(re.escape, names)) + r")\b")
    busy = sum(sec for name, sec in t["device_ops"] if pat.search(name))
    if busy <= 0:
        return None
    least, _ = bound(probed / rec["window"]["calls"], rec["shape"]["n"],
                     rec["shape"]["dim"])
    return least / (busy / t["calls"]) * 100.0
