"""Per-sample min-max rescale, the dynamic-range map and the uint8
post-processing (counterpart of `gan_discovery_pso_tpu/ops/rescale.py:30,
44,55`).

The discovery fitness rescales each generated image to [0, 1] by its own
min and max. This is the plain version; the fitness path calls the kernel
wrapper `ops/kernels/rescale.py:rescale01_per_sample`, which takes this
arithmetic on the CPU and launches the CUDA kernel on the card.
"""

from __future__ import annotations

import numpy as np
import torch


def rescale01_per_sample(imgs: torch.Tensor) -> torch.Tensor:
    """[N, ...] → (x − min) / (max − min) per sample, clamped to [0, 1].

    The clamp propagates NaN (a constant image gives 0/0), as `jnp.clip`
    does."""
    dims = tuple(range(1, imgs.ndim))
    mn = torch.amin(imgs, dim=dims, keepdim=True)
    mx = torch.amax(imgs, dim=dims, keepdim=True)
    return torch.clamp((imgs - mn) / (mx - mn), 0.0, 1.0)


def adjust_dynamic_range(data, drange_in, drange_out):
    """Affine drange map (reference src/utils/util_data.py:116-121), scale
    and bias in fp32 as the JAX package computes them; `data` is a numpy
    array or a tensor, returned as it came when the ranges agree."""
    if tuple(drange_in) == tuple(drange_out):
        return data
    f32 = np.float32
    scale = (f32(drange_out[1]) - f32(drange_out[0])) / (f32(drange_in[1]) - f32(drange_in[0]))
    bias = f32(drange_out[0]) - f32(drange_in[0]) * scale
    # python floats of fp32 values: an fp32 array or tensor stays fp32
    return data * float(scale) + float(bias)


def postprocess_uint8(images: torch.Tensor, min_val: float = -1.0,
                      max_val: float = 1.0) -> torch.Tensor:
    """[min, max] floats → uint8 [0, 255] with the reference's +0.5 rounding
    (src/inverter/utils_ae/util_inverter.py:497-522); the cast truncates, as
    the JAX package's does."""
    images = (images - min_val) * 255.0 / (max_val - min_val)
    return torch.clamp(images + 0.5, 0, 255).to(torch.uint8)
