"""The inverter's encoders E: image → z (counterpart of
`gan_discovery_pso_tpu/models/encoder.py:1-98`).

It mirrors the discriminator's conv stack but ends in `enc_dim` channels
with no sigmoid (reference src/inverter/utils_ae/util_inverter.py:164-184):

    x [N, C, 28, 28]
      → Conv(C,  f,  k4, s2, p1) + LeakyReLU(0.2)   → [N, f, 14, 14]
      → Conv(f,  2f, k4, s2, p1) + LeakyReLU(0.2)   → [N, 2f, 7, 7]
      → Conv(2f, z,  k7, s2, p0)                    → [N, z, 1, 1]

Submodules carry the reference's state-dict names (`enc.0`, `enc.2.0`,
`enc.3`), so a reference `encoder.pt` and `compat/weights.py` output load
with `strict=True`.

`EncoderAttGAN` is the alternative stack (reference util_inverter.py:
142-162): `enc_layers` blocks of Conv(k4, s2, p1, no bias) + BatchNorm +
ReLU with widths min(f·2^i, enc_dim), so 28 → 14 → 7 → 3 → 1 with four
blocks and z [N, enc_dim, 1, 1]. Its blocks are AttGAN's `Conv2dBlock`s
(`enc_layers.{i}.layers.0` the conv, `.1` the BN). It follows the module's
mode: train mode normalises with the batch statistics and updates the
running ones in place (`ops.batch_norm_train`), eval mode uses the running
ones.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from gan_discovery_pso_tpu_torch.ops import batch_norm_eval, batch_norm_train, conv2d


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


class EncoderAttGANDef(NamedTuple):
    enc_dim: int
    channels_img: int = 1
    features_e: int = 16
    enc_layers: int = 4


class _Conv2dBlock(nn.Module):
    def __init__(self, n_in: int, n_out: int, **kw):
        super().__init__()
        self.layers = nn.Sequential(nn.Conv2d(n_in, n_out, 4, 2, 1, bias=False, **kw),
                                    nn.BatchNorm2d(n_out, **kw), nn.ReLU())


class EncoderAttGAN(nn.Module):
    def __init__(self, d: EncoderAttGANDef, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        blocks, n_in = [], d.channels_img
        for i in range(d.enc_layers):
            n_out = min(d.features_e * 2 ** i, d.enc_dim)
            blocks.append(_Conv2dBlock(n_in, n_out, **kw))
            n_in = n_out
        self.enc_layers = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, C, 28, 28] → z [N, enc_dim, 1, 1] (four blocks)."""
        h = x
        for block in self.enc_layers:
            conv, bn = block.layers[0], block.layers[1]
            h = conv2d(h, conv.weight, None, conv.stride, conv.padding)
            norm = batch_norm_train if bn.training else batch_norm_eval
            h = torch.relu(norm(h, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                eps=bn.eps))
        return h
