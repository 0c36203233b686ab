"""The port's one rule for devices: the caller names it.

Every public constructor takes ``device`` (default ``"cuda"``).  Nothing
probes for a GPU and carries on on the host: asking for CUDA on a machine
without it raises, and tests pass ``device="cpu"``.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent, or when the device type is neither cuda nor cpu."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: cuda or cpu")
    return dev


@contextlib.contextmanager
def on_default_stream(device: torch.device):
    """Run the enclosed work on ``device``'s default stream, after the work
    the caller's current stream holds so far, and make the caller's stream
    wait for it at the end.

    The database writes its store and refreshes its caches in place, so a
    search must run after every write acknowledged before it began: on one
    stream the card keeps that order, whatever stream the calling thread
    has made current (a search on a stream of its own otherwise reads rows
    and masks the default stream has not written yet).  A no-op on the CPU
    and for a caller already on the default stream."""
    if device.type != "cuda":
        yield
        return
    caller = torch.cuda.current_stream(device)
    default = torch.cuda.default_stream(device)
    if caller == default:
        yield
        return
    default.wait_stream(caller)
    try:
        with torch.cuda.stream(default):
            yield
    finally:
        caller.wait_stream(default)
