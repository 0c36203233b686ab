"""decode_roofline: the PQ decode kernel's (B3, ``pq_decode_recon_t``)
least time a call over its device time a call, in percent of the published
HBM bandwidth.

The least time: the code columns the kernel reconstructed in the window
(the program's counter ``adc.decoded_rows``) over the window's calls, each
column read as S one-byte codes and written as d bf16 values, (S + 2 d)
bytes, at ``roofline.HBM_BYTES_S``.  The device time: the device-only
stretch's operations whose names ``kernels/pq_decode_recon_t.json`` gives,
over the stretch's calls.  Nothing off the card, where the program counts
no decoded columns, or where the kernel is not among the stretch's
operations (``trace.py`` keeps its ten longest)."""

import json
import re
from pathlib import Path

from perfbench import roofline

KERNELS = Path(__file__).resolve().parent.parent / "kernels" \
    / "pq_decode_recon_t.json"


def bound_s(columns: float, s: int, d: int) -> float:
    """Seconds to read ``columns`` code columns of ``s`` bytes and write
    their ``d`` bf16 values once at the published bandwidth."""
    return columns * (s + 2 * d) / roofline.HBM_BYTES_S


def read(rec):
    t = rec["device_trace"]
    decoded = rec["program"]["counts"].get("adc.decoded_rows", 0)
    if not t or not decoded or not rec["window"]["calls"]:
        return None
    names = json.loads(KERNELS.read_text())["device_names"]
    pat = re.compile(r"(?<![A-Za-z0-9_])(?:"
                     + "|".join(map(re.escape, names)) + r")\b")
    busy = sum(sec for name, sec in t["device_ops"] if pat.search(name))
    if busy <= 0:
        return None
    least = bound_s(decoded / rec["window"]["calls"],
                    rec["config"]["index_config"]["num_subspaces"],
                    rec["shape"]["dim"])
    return least / (busy / t["calls"]) * 100.0
