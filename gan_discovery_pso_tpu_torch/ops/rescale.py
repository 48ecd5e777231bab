"""Per-sample min-max rescale (counterpart of
`gan_discovery_pso_tpu/ops/rescale.py:30`).

The discovery fitness rescales each generated image to [0, 1] by its own
min and max. This is the plain version; the fitness path calls the kernel
wrapper `ops/kernels/rescale.py:rescale01_per_sample`, which takes this
arithmetic on the CPU and launches the CUDA kernel on the card.
"""

from __future__ import annotations

import torch


def rescale01_per_sample(imgs: torch.Tensor) -> torch.Tensor:
    """[N, ...] → (x − min) / (max − min) per sample, clamped to [0, 1].

    The clamp propagates NaN (a constant image gives 0/0), as `jnp.clip`
    does."""
    dims = tuple(range(1, imgs.ndim))
    mn = torch.amin(imgs, dim=dims, keepdim=True)
    mx = torch.amax(imgs, dim=dims, keepdim=True)
    return torch.clamp((imgs - mn) / (mx - mn), 0.0, 1.0)
