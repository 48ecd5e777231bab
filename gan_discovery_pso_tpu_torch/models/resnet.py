"""Bottleneck ResNet-50/101/152 assessors (counterpart of
`gan_discovery_pso_tpu/models/resnet.py:38-160`).

Reference src/pso/util_cnn.py:81-190, quirks kept:
- the pooling head is a global MAX pool (`AdaptiveMaxPool2d((1, 1))`,
  util_cnn.py:99), though the reference names it `avgpool`;
- convs are bias-free; the head is Linear(512·4, n_class);
- `features` returns the pooled 2048-d vector (`forward_avgpool`, the
  perceptual head, util_cnn.py:119-133).

Submodules carry the reference's state-dict names (`conv1`, `bn1`,
`layerX.Y.convZ`/`bnZ`, `layerX.Y.identity_downsample.{0,1}`, `fc`), so a
reference checkpoint and `compat/weights.py` output load with `strict=True`.
The forward follows the module's mode: in eval mode BN normalises with the
running statistics, in train mode with the batch's and updates the running
ones (`ops.batch_norm_train`, torch's semantics). `change_classifier_head`
re-heads a trained assessor for transfer (the pso-inverter's binary
fine-tune).
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import torch
from torch import nn

from gan_discovery_pso_tpu_torch.models.layers import linear, torch_default_linear_
from gan_discovery_pso_tpu_torch.ops import (
    adaptive_max_pool2d,
    batch_norm_eval,
    batch_norm_train,
    conv2d,
    max_pool2d,
)

_LAYERS = {"ResNet50": (3, 4, 6, 3), "ResNet101": (3, 4, 23, 3), "ResNet152": (3, 8, 36, 3)}
_EXPANSION = 4


class ResNetDef(NamedTuple):
    model_name: str = "ResNet50"
    image_channels: int = 1
    n_class: int = 2
    iid_classes: tuple = ()

    @property
    def layers(self) -> tuple:
        return _LAYERS[self.model_name]

    def class_to_idx(self) -> dict:
        """Sorted IiD class labels → logit columns (util_cnn.py:90-91)."""
        return {c: i for i, c in enumerate(sorted(self.iid_classes))}


def _conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    h = conv2d(x, conv.weight, None, conv.stride, conv.padding)
    norm = batch_norm_train if bn.training else batch_norm_eval
    return norm(h, bn.weight, bn.bias, bn.running_mean, bn.running_var, eps=bn.eps)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, width: int, stride: int, downsample: bool, **kw):
        super().__init__()
        out_ch = width * _EXPANSION
        self.conv1 = nn.Conv2d(in_ch, width, 1, 1, 0, bias=False, **kw)
        self.bn1 = nn.BatchNorm2d(width, **kw)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False, **kw)
        self.bn2 = nn.BatchNorm2d(width, **kw)
        self.conv3 = nn.Conv2d(width, out_ch, 1, 1, 0, bias=False, **kw)
        self.bn3 = nn.BatchNorm2d(out_ch, **kw)
        self.identity_downsample = (
            nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride, 0, bias=False, **kw),
                          nn.BatchNorm2d(out_ch, **kw))
            if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(_conv_bn(self.conv1, self.bn1, x))
        h = torch.relu(_conv_bn(self.conv2, self.bn2, h))
        h = _conv_bn(self.conv3, self.bn3, h)
        if self.identity_downsample is not None:
            x = _conv_bn(self.identity_downsample[0], self.identity_downsample[1], x)
        return torch.relu(h + x)


class ResNet(nn.Module):
    def __init__(self, d: ResNetDef, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.conv1 = nn.Conv2d(d.image_channels, 64, 7, 2, 3, bias=False, **kw)
        self.bn1 = nn.BatchNorm2d(64, **kw)
        in_ch = 64
        for li, (n_blocks, width, stride) in enumerate(
                zip(d.layers, (64, 128, 256, 512), (1, 2, 2, 2)), start=1):
            blocks = []
            for bi in range(n_blocks):
                s = stride if bi == 0 else 1
                blocks.append(Bottleneck(
                    in_ch, width, s,
                    bi == 0 and (s != 1 or in_ch != width * _EXPANSION), **kw))
                in_ch = width * _EXPANSION
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.fc = nn.Linear(512 * _EXPANSION, d.n_class, **kw)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, C, H, W] → the global-max-pooled feature [N, 2048]."""
        h = torch.relu(_conv_bn(self.conv1, self.bn1, x))
        h = max_pool2d(h, 3, 2, 1)
        h = self.layer4(self.layer3(self.layer2(self.layer1(h))))
        h = adaptive_max_pool2d(h, (1, 1))
        return h.reshape(h.shape[0], -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, C, H, W] → logits [N, n_class]."""
        return linear(self.features(x), self.fc.weight, self.fc.bias)


def change_classifier_head(model: ResNet, n_class: int, generator: torch.Generator) -> ResNet:
    """A copy of `model` with a new Linear(2048, n_class) head, initialised
    as torch does by default, drawn from `generator` (on the CPU, so the
    head does not depend on the device) — the reference's
    `change_classifier_n_class` (src/pso/util_pso_inverter.py:10-12). The
    trunk's weights and BN statistics are copied; `model` is left as it
    is."""
    out = copy.deepcopy(model)
    fc = torch_default_linear_(nn.Linear(512 * _EXPANSION, n_class), generator)
    out.fc = fc.to(model.fc.weight.device, model.fc.weight.dtype)
    return out
