"""Device policy of the port's entry points.

Entry points run on the CUDA card unless the caller names another device.
A host without CUDA does not quietly fall back to the CPU: a call that names
no device raises there, so a measurement never reports CPU numbers as the
card's. Tests pass `device="cpu"` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`device`, or the CUDA card when it is None; raise if the resolved
    device is CUDA and this host has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device on this host; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
