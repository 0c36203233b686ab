"""Peaks of the card and the least time of a search's exhaustive scan.

The peaks are NVIDIA's published figures for one H100 SXM (dense, at the
full 700 W power limit), as ``chip_smoke.py`` has them: a share against
them is stated beside the card's power limit, which ``run.py`` records.

The scan's least time is defined from the cell's shapes alone, so it reads
the same work whatever implements it: every one of the N rows is read
once at one byte a dimension (the most compact form in which the raw store
is scanned, the int8 shadow), and every query meets every row at int8's
peak rate::

    max(N * d / HBM_BYTES_S, 2 * Q * N * d / PEAK_OPS_S["int8"])

A mode that reads fewer bytes a row (PQ codes, pruning) can beat it; such
a mode needs a new definition, and a new metric.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def scan_bound(n: int, d: int, q: int) -> tuple[float, str]:
    """(seconds, "bytes" or "ops"): the least time of one exhaustive scan
    of ``n`` rows of ``d`` dimensions for ``q`` queries."""
    t_bytes = n * d / HBM_BYTES_S
    t_ops = 2.0 * q * n * d / PEAK_OPS_S["int8"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")
