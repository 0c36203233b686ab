"""The port's one rule for devices: the caller names it.

Every public constructor takes ``device`` (default ``"cuda"``).  Nothing
probes for a GPU and carries on on the host: asking for CUDA on a machine
without it raises, and tests pass ``device="cpu"``.
"""

from __future__ import annotations

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
