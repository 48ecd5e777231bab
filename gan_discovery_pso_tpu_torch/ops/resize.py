"""Bilinear resize with antialiasing on downsampling (it stands in for
`jax.image.resize(..., "linear")` at `gan_discovery_pso_tpu/data/medical.py:88-92`,
`jax.image.resize(..., "bilinear")` at `data/mnist.py:89-104`, and PIL's
`Image.resize(..., BILINEAR)` on mode `F` at `data/medical.py:141-147`).

All three sample at half-pixel centres and widen the triangle filter by the
scale factor when they shrink an image, which is what
`F.interpolate(mode="bilinear", antialias=True, align_corners=False)`
computes. On the CPU it agrees with each of them within 2e-6 of the
input's range (the worst case, 97 → 31 against JAX, is 1.6e-6;
tests/test_torch_port_claro.py); without antialias a downsample is 0.4-0.9
off. The CUDA path is another implementation of the same filter, held to
the CPU's by chip_smoke.py.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """[..., H, W] → [..., size, size], in float32 on x's device."""
    flat = x.reshape(-1, 1, *x.shape[-2:]).to(torch.float32)
    out = F.interpolate(flat, size=(size, size), mode="bilinear", antialias=True,
                        align_corners=False)
    return out.reshape(*x.shape[:-2], size, size)
