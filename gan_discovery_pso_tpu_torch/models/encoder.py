"""The inverter's plain encoder E: image → z (counterpart of
`gan_discovery_pso_tpu/models/encoder.py:1-53`).

It mirrors the discriminator's conv stack but ends in `enc_dim` channels
with no sigmoid (reference src/inverter/utils_ae/util_inverter.py:164-184):

    x [N, C, 28, 28]
      → Conv(C,  f,  k4, s2, p1) + LeakyReLU(0.2)   → [N, f, 14, 14]
      → Conv(f,  2f, k4, s2, p1) + LeakyReLU(0.2)   → [N, 2f, 7, 7]
      → Conv(2f, z,  k7, s2, p0)                    → [N, z, 1, 1]

Submodules carry the reference's state-dict names (`enc.0`, `enc.2.0`,
`enc.3`), so a reference `encoder.pt` and `compat/weights.py` output load
with `strict=True`. The AttGAN variant (`EncoderAttGAN`) waits for the
encoder's training (ROADMAP A12).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from gan_discovery_pso_tpu_torch.ops import conv2d


class EncoderDef(NamedTuple):
    enc_dim: int
    channels_img: int = 1
    features_e: int = 64


class Encoder(nn.Module):
    def __init__(self, d: EncoderDef, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        f = d.features_e
        self.enc = nn.Sequential(
            nn.Conv2d(d.channels_img, f, 4, 2, 1, **kw),
            nn.LeakyReLU(0.2),
            nn.Sequential(nn.Conv2d(f, f * 2, 4, 2, 1, **kw), nn.LeakyReLU(0.2)),
            nn.Conv2d(f * 2, d.enc_dim, 7, 2, 0, **kw),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, C, 28, 28] → z [N, enc_dim, 1, 1]."""
        h = x
        for conv in (self.enc[0], self.enc[2][0]):
            h = F.leaky_relu(conv2d(h, conv.weight, conv.bias, conv.stride, conv.padding), 0.2)
        head = self.enc[3]
        return conv2d(h, head.weight, head.bias, head.stride, head.padding)
