"""The GAN evaluation's sampler (counterpart of
`gan_discovery_pso_tpu/train/dcgan.py:191-205 make_sampler`). The DCGAN
training steps of that module are a later slice (ROADMAP A9).

The reference synthesised ONE image per DataLoader item
(src/utils/util_data.py:422-445); here a batch of z goes through the frozen
generator in one forward, and each image is rescaled to [0, 1] by its own
min and max through the B2 kernel's wrapper (`ops/kernels/rescale.py`):
the CUDA kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from gan_discovery_pso_tpu_torch.ops.kernels import rescale01_per_sample
from gan_discovery_pso_tpu_torch.ops.precision import fp32_parity


def make_sampler(gen: nn.Module) -> Callable[..., torch.Tensor]:
    """sample(batch, generator=None, z=None) → [batch, C, H, W] in [0, 1]:
    G(z) in eval mode and fp32 parity, z [batch, z_dim, 1, 1] drawn from
    `generator` on G's device unless given."""
    z_dim = gen.gen[0][0].in_channels
    device = gen.gen[0][0].weight.device

    @torch.no_grad()
    def sample(batch: int, generator: torch.Generator | None = None,
               z: torch.Tensor | None = None) -> torch.Tensor:
        if z is None:
            z = torch.randn((batch, z_dim, 1, 1), generator=generator, device=device)
        with fp32_parity():
            return rescale01_per_sample(gen.eval()(z.to(device)))

    return sample
