"""DCGAN generator and discriminator (counterpart of
`gan_discovery_pso_tpu/models/dcgan.py:48-126`).

Reference src/utils/util_dcgan.py:128-149:

    z [N, z_dim, 1, 1]
      → ConvT(z_dim, 2f, k7, s1, p0) + BN + ReLU   → [N, 2f, 7, 7]
      → ConvT(2f,   f,  k4, s2, p1) + BN + ReLU    → [N, f, 14, 14]
      → ConvT(f,    C,  k4, s2, p1) + Tanh         → [N, C, 28, 28]

Submodules carry the reference's state-dict names (`gen.0.0`, `gen.0.1`,
`gen.1.0`, `gen.1.1`, `gen.2`), so a reference checkpoint and
`compat/weights.py` output load with `strict=True`. The module's mode picks
the BN statistics, as `generator_apply(train=)` does: in eval mode (the PSO
fitness path, the sampler, every loader's return) the running statistics;
in train mode (the DCGAN train step) the batch's, and the running
statistics move once per forward, in place (`ops/norm.py
batch_norm_train`).

Discriminator (reference src/utils/util_dcgan.py:103-125; the inverter's
adversary, util_inverter.py:95-140):

    x [N, C, 28, 28]
      → Conv(C,  f,  k4, s2, p1) + LeakyReLU(0.2)  → [N, f, 14, 14]
      → Conv(f,  2f, k4, s2, p1) + LeakyReLU(0.2)  → [N, 2f, 7, 7]
      → Conv(2f, 1,  k7, s2, p0) + Sigmoid         → [N, 1, 1, 1]

with the reference's names `disc.0`, `disc.2.0`, `disc.3`. It has no state
(the reference's BN is commented out). `logits` is the pre-sigmoid trunk as
[N], for the stable BCE.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from gan_discovery_pso_tpu_torch.ops import (
    batch_norm_eval,
    batch_norm_train,
    conv2d,
    conv_transpose2d,
)


class GeneratorDef(NamedTuple):
    z_dim: int
    channels_img: int = 1
    features_g: int = 64


class DiscriminatorDef(NamedTuple):
    channels_img: int = 1
    features_d: int = 64


def _block(cin, cout, k, s, p, **kw):
    return nn.Sequential(nn.ConvTranspose2d(cin, cout, k, s, p, **kw),
                         nn.BatchNorm2d(cout, **kw), nn.ReLU())


class Generator(nn.Module):
    def __init__(self, d: GeneratorDef, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        f = d.features_g
        self.gen = nn.Sequential(
            _block(d.z_dim, f * 2, 7, 1, 0, **kw),
            _block(f * 2, f, 4, 2, 1, **kw),
            nn.ConvTranspose2d(f, d.channels_img, 4, 2, 1, **kw),
            nn.Tanh(),
        )

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z [N, z_dim, 1, 1] → images [N, C, 28, 28] in [-1, 1]; BN by the
        batch in train mode, by the running statistics in eval mode."""
        h = z
        for block in self.gen[:2]:
            conv, bn = block[0], block[1]
            h = conv_transpose2d(h, conv.weight, conv.bias, conv.stride, conv.padding)
            if self.training:
                h = batch_norm_train(h, bn.weight, bn.bias, bn.running_mean,
                                     bn.running_var, bn.momentum, bn.eps)
            else:
                h = batch_norm_eval(h, bn.weight, bn.bias, bn.running_mean,
                                    bn.running_var, bn.eps)
            h = torch.relu(h)
        head = self.gen[2]
        return torch.tanh(conv_transpose2d(h, head.weight, head.bias,
                                           head.stride, head.padding))


class Discriminator(nn.Module):
    def __init__(self, d: DiscriminatorDef, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        f = d.features_d
        self.disc = nn.Sequential(
            nn.Conv2d(d.channels_img, f, 4, 2, 1, **kw),
            nn.LeakyReLU(0.2),
            nn.Sequential(nn.Conv2d(f, f * 2, 4, 2, 1, **kw), nn.LeakyReLU(0.2)),
            nn.Conv2d(f * 2, 1, 7, 2, 0, **kw),
            nn.Sigmoid(),
        )

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, C, 28, 28] → pre-sigmoid logits [N]."""
        h = x
        for conv in (self.disc[0], self.disc[2][0]):
            h = F.leaky_relu(conv2d(h, conv.weight, conv.bias, conv.stride, conv.padding), 0.2)
        head = self.disc[3]
        h = conv2d(h, head.weight, head.bias, head.stride, head.padding)
        return h.reshape(h.shape[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, C, 28, 28] → D(x) [N, 1, 1, 1] in (0, 1)."""
        return torch.sigmoid(self.logits(x)).reshape(-1, 1, 1, 1)
