"""The denoising convolutional autoencoder, the feature net of every GAN
metric (counterpart of `gan_discovery_pso_tpu/models/cae.py`; reference
src/evaluation/util_cae.py:103-165):

Encoder (input 1x28x28):
    Conv(1, 8, k3, s2, p1) + ReLU        → [N, 8, 14, 14]
    Conv(8, 16, k3, s2, p1) + BN + ReLU  → [N, 16, 7, 7]
    Conv(16, 32, k3, s2, p0) + ReLU      → [N, 32, 3, 3]
    flatten → Linear(288, 128) + ReLU → Linear(128, latent)

Decoder:
    Linear(latent, 128) + ReLU → Linear(128, 288) + ReLU → unflatten (32, 3, 3)
    ConvT(32, 16, k3, s2, p0)        + BN + ReLU  → [N, 16, 7, 7]
    ConvT(16, 8,  k3, s2, p1, op1)   + BN + ReLU  → [N, 8, 14, 14]
    ConvT(8,  1,  k3, s2, p1, op1)   + Sigmoid    → [N, 1, 28, 28]

The submodules carry the reference's state-dict names (`encoder_cnn.{0,2,3,
5}`, `encoder_linear.{0,2}`, `decoder_linear.{0,2}`, `decoder_conv.{0,1,3,4,
6}`, JAX `compat/torch_export.py:89-110`). The forward follows the module's
mode: eval BN normalises with the running statistics, train BN with the
batch's and updates the running ones.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from gan_discovery_pso_tpu_torch.models.layers import linear
from gan_discovery_pso_tpu_torch.ops import (
    batch_norm_eval,
    batch_norm_train,
    conv2d,
    conv_transpose2d,
)


class CAEDef(NamedTuple):
    latent_dim: int = 10


def _bn(bn: nn.BatchNorm2d, h: torch.Tensor) -> torch.Tensor:
    norm = batch_norm_train if bn.training else batch_norm_eval
    return norm(h, bn.weight, bn.bias, bn.running_mean, bn.running_var, eps=bn.eps)


class CAEEncoder(nn.Module):
    def __init__(self, d: CAEDef, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.encoder_cnn = nn.Sequential(
            nn.Conv2d(1, 8, 3, 2, 1, **kw), nn.ReLU(), nn.Conv2d(8, 16, 3, 2, 1, **kw),
            nn.BatchNorm2d(16, **kw), nn.ReLU(), nn.Conv2d(16, 32, 3, 2, 0, **kw), nn.ReLU())
        self.encoder_linear = nn.Sequential(
            nn.Linear(3 * 3 * 32, 128, **kw), nn.ReLU(), nn.Linear(128, d.latent_dim, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, 1, 28, 28] in [0, 1] → z [N, latent]."""
        c, fc = self.encoder_cnn, self.encoder_linear
        h = torch.relu(conv2d(x, c[0].weight, c[0].bias, 2, 1))
        h = torch.relu(_bn(c[3], conv2d(h, c[2].weight, c[2].bias, 2, 1)))
        h = torch.relu(conv2d(h, c[5].weight, c[5].bias, 2, 0))
        h = torch.relu(linear(h.reshape(h.shape[0], -1), fc[0].weight, fc[0].bias))
        return linear(h, fc[2].weight, fc[2].bias)


class CAEDecoder(nn.Module):
    def __init__(self, d: CAEDef, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.decoder_linear = nn.Sequential(
            nn.Linear(d.latent_dim, 128, **kw), nn.ReLU(), nn.Linear(128, 3 * 3 * 32, **kw),
            nn.ReLU())
        self.decoder_conv = nn.Sequential(
            nn.ConvTranspose2d(32, 16, 3, 2, 0, **kw), nn.BatchNorm2d(16, **kw), nn.ReLU(),
            nn.ConvTranspose2d(16, 8, 3, 2, 1, 1, **kw), nn.BatchNorm2d(8, **kw), nn.ReLU(),
            nn.ConvTranspose2d(8, 1, 3, 2, 1, 1, **kw))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z [N, latent] → images [N, 1, 28, 28] in [0, 1]."""
        fc, c = self.decoder_linear, self.decoder_conv
        h = torch.relu(linear(z, fc[0].weight, fc[0].bias))
        h = torch.relu(linear(h, fc[2].weight, fc[2].bias)).reshape(z.shape[0], 32, 3, 3)
        h = torch.relu(_bn(c[1], conv_transpose2d(h, c[0].weight, c[0].bias, 2, 0)))
        h = torch.relu(_bn(c[4], conv_transpose2d(h, c[3].weight, c[3].bias, 2, 1, 1)))
        return torch.sigmoid(conv_transpose2d(h, c[6].weight, c[6].bias, 2, 1, 1))


def add_noise(x: torch.Tensor, noise_factor: float = 0.3, noise: torch.Tensor | None = None,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """The denoising corruption x + nf·N(0, 1), clipped to [0, 1] (reference
    util_cae.py:28-31). The N(0, 1) draw is `noise`, or is drawn from
    `generator` on x's device (tests feed the JAX package's draw)."""
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return torch.clamp(x + noise_factor * noise, 0.0, 1.0)
