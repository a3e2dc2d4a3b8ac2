"""Device resolution for the port's entry points.

The entry points run on the card unless the caller asks for the CPU; a
request for CUDA on a host without a usable card raises instead of
carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """"cuda" (or "cuda:N") or "cpu" -> torch.device; raises if CUDA is
    asked for and unavailable."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {name}: CUDA is not available on this host "
                "(pass --device cpu to run on the CPU)")
        return device
    if device.type == "cpu":
        return device
    raise ValueError(f"unsupported device {name!r} (expected cuda or cpu)")
