"""Gated PixelCNN prior over VQ-VAE code indices (counterpart of
`gan_discovery_pso_tpu/models/pixelcnn.py`: `PixelCNNDef` :26,
`pixelcnn_init` :33, the gated layer :72-95, `pixelcnn_apply` :98,
`pixelcnn_loss` :112, `pixelcnn_generate` :139).

Reference src/inverter/utils_vq_vae/util_model.py:325-448: class-
conditioned gated masked convolutions over the latent grid, a vertical and
a horizontal stack. The reference zeroes the first layer's weights IN PLACE
at every forward for its type-A causal mask (`make_causal`, :365-367); here
the mask is a constant tensor that multiplies the weight inside the
forward, so the stored weights never change and the masked entries get a
zero gradient.

Parameter names are the JAX tree's keys: `embedding` [K, dim],
`layers.{i}.class_embed` [n_classes, 2·dim], `layers.{i}.{vert,v2h,horiz,
h_res}`, `out1`, `out2`. The seeded init: N(0, 1) embeddings (torch's
nn.Embedding default), xavier-uniform conv weights, zero conv biases
(weights_init, util_model.py:39-46).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from gan_discovery_pso_tpu_torch.ops import conv2d


class PixelCNNDef(NamedTuple):
    input_dim: int = 256  # codebook size K
    dim: int = 64
    n_layers: int = 15
    n_classes: int = 10


def _gate(x: torch.Tensor) -> torch.Tensor:
    a, b = torch.chunk(x, 2, dim=1)
    return torch.tanh(a) * torch.sigmoid(b)


class GatedLayer(nn.Module):
    """One gated masked layer (reference GatedMaskedConv2d,
    util_model.py:343-388): kernel k (7 for the first, type A; 3 after,
    type B with the horizontal residual)."""

    def __init__(self, dim: int, n_classes: int, k: int, mask_type: str):
        super().__init__()
        self.k, self.mask_type = k, mask_type
        self.class_embed = nn.Parameter(torch.empty(n_classes, 2 * dim))
        self.vert = nn.Conv2d(dim, 2 * dim, (k // 2 + 1, k))
        self.v2h = nn.Conv2d(2 * dim, 2 * dim, 1)
        self.horiz = nn.Conv2d(dim, 2 * dim, (1, k // 2 + 1))
        self.h_res = nn.Conv2d(dim, dim, 1)

    def _masked(self, conv: nn.Conv2d, which: str) -> torch.Tensor:
        """Type A: the vertical kernel's last row, the horizontal kernel's
        last column times 0."""
        w = conv.weight
        if self.mask_type != "A":
            return w
        mask = torch.ones_like(w)
        if which == "vert":
            mask[:, :, -1, :] = 0.0
        else:
            mask[:, :, :, -1] = 0.0
        return w * mask

    def forward(self, x_v: torch.Tensor, x_h: torch.Tensor, label: torch.Tensor) -> tuple:
        k = self.k
        cond = F.embedding(label, self.class_embed)[:, :, None, None]
        h_vert = conv2d(x_v, self._masked(self.vert, "vert"), self.vert.bias,
                        padding=(k // 2, k // 2))[:, :, : x_v.shape[2], :]
        out_v = _gate(h_vert + cond)
        h_horiz = conv2d(x_h, self._masked(self.horiz, "horiz"), self.horiz.bias,
                         padding=(0, k // 2))[:, :, :, : x_h.shape[3]]
        v2h = conv2d(h_vert, self.v2h.weight, self.v2h.bias)
        out = _gate(v2h + h_horiz + cond)
        res = conv2d(out, self.h_res.weight, self.h_res.bias)
        return out_v, (res + x_h if self.mask_type == "B" else res)


class PixelCNN(nn.Module):
    """idx [N, H, W] int code indices, label [N] → logits [N, K, H, W]."""

    def __init__(self, d: PixelCNNDef, generator: torch.Generator | None = None):
        super().__init__()
        self.d = d
        self.embedding = nn.Parameter(torch.empty(d.input_dim, d.dim))
        self.layers = nn.ModuleList(
            GatedLayer(d.dim, d.n_classes, 7 if i == 0 else 3, "A" if i == 0 else "B")
            for i in range(d.n_layers))
        self.out1 = nn.Conv2d(d.dim, 512, 1)
        self.out2 = nn.Conv2d(512, d.input_dim, 1)
        with torch.no_grad():
            nn.init.normal_(self.embedding, generator=generator)
            for layer in self.layers:
                nn.init.normal_(layer.class_embed, generator=generator)
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    nn.init.xavier_uniform_(m.weight, generator=generator)
                    nn.init.zeros_(m.bias)

    def forward(self, idx: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        x = F.embedding(idx, self.embedding).permute(0, 3, 1, 2)
        x_v = x_h = x
        for layer in self.layers:
            x_v, x_h = layer(x_v, x_h, label)
        out = torch.relu(conv2d(x_h, self.out1.weight, self.out1.bias))
        return conv2d(out, self.out2.weight, self.out2.bias)


def pixelcnn_loss(model: PixelCNN, idx: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """The mean cross-entropy of every grid position's code."""
    logits = model(idx, label).permute(0, 2, 3, 1).reshape(-1, model.d.input_dim)
    return F.cross_entropy(logits, idx.reshape(-1).long())


@torch.no_grad()
def pixelcnn_generate(model: PixelCNN, label: torch.Tensor, shape=(8, 8),
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """Raster-order sampling on the host loop, one full-grid forward per
    position (reference generate, util_model.py:434-448): [N, H, W] codes,
    each drawn from the softmax of its logits."""
    x = torch.zeros((label.shape[0], *shape), dtype=torch.long, device=label.device)
    for i in range(shape[0]):
        for j in range(shape[1]):
            probs = torch.softmax(model(x, label)[:, :, i, j], dim=-1)
            x[:, i, j] = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return x
