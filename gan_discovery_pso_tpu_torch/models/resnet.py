"""Bottleneck ResNet-50/101/152 and AlexNet assessors (counterpart of
`gan_discovery_pso_tpu/models/resnet.py:38-160` and `AlexNetDef`,
`alexnet_apply`, `_dropout2d_like` :164-247).

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
ones (`ops.batch_norm_train`, torch's semantics). Inside
`folded_batch_norm(model)`, each eval BN of an fp32 ResNet is folded into
the conv before it (`ops.fold_batch_norm`): the forward runs the conv with
the folded weight and bias and no BN pass. A BN in train mode, bf16
weights and every forward outside the context run the BN as above.
`change_classifier_head` re-heads a trained assessor for transfer (the
pso-inverter's binary fine-tune).

AlexNet (reference util_cnn.py:193-249): 4 x (conv k, stride 1, pad p, with
bias → activation → max_pool2d(2)), then fc1 → act → fc2 → act → fc3, the
activation LeakyReLU(0.2) or ReLU (`model_cnn.network.cnn_activation`).
Quirk kept from the JAX package: its train step applies the model without a
dropout key, so `_dropout2d_like` returns its input and AlexNet TRAINS
WITHOUT DROPOUT. Here dropout (elementwise, p = 0.5, after fc1 and fc2)
runs only in train mode and only when a `generator` is passed to forward;
`train_cnn` passes none. Parameters carry the JAX tree's names (`conv1`…
`conv4`, `fc1`…`fc3`): the JAX package has no reference name map for it.
With the shipped `padding: valid` and kernel 3, a 28x28 input shrinks to
-1 at the fourth conv (`conv_sizes`), so no forward runs; use
`padding: same` at 28x28.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from gan_discovery_pso_tpu_torch.core.profiling import span
from gan_discovery_pso_tpu_torch.models.layers import linear, torch_default_linear_
from gan_discovery_pso_tpu_torch.ops import (
    adaptive_max_pool2d,
    batch_norm_eval,
    batch_norm_train,
    conv2d,
    fold_batch_norm,
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


# conv -> (weight, bias) of its folded BN, inside `folded_batch_norm`
_FOLDED = contextvars.ContextVar("folded_batch_norm", default={})


def _conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    folded = _FOLDED.get().get(conv)
    if folded is not None and not bn.training:
        return conv2d(x, folded[0], folded[1], conv.stride, conv.padding)
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


def _conv_bn_pairs(model: ResNet) -> list:
    """Every (conv, BN) pair of a ResNet's forward."""
    pairs = [(model.conv1, model.bn1)]
    for block in model.modules():
        if isinstance(block, Bottleneck):
            pairs += [(block.conv1, block.bn1), (block.conv2, block.bn2),
                      (block.conv3, block.bn3)]
            if block.identity_downsample is not None:
                pairs.append(tuple(block.identity_downsample))
    return pairs


@contextlib.contextmanager
def folded_batch_norm(model: nn.Module):
    """Inside, `model`'s forwards run each eval BN folded into the conv
    before it, for every pair of a `ResNet` whose BN is in eval mode and
    whose conv weight is float32: the module itself, not a copy, so hooks
    on it fire. The folds are computed once, on entry, from the weights
    and statistics as they are then (a `models.fold` span where any pair
    folds); they are kept beside the module, never in its parameters,
    buffers or `state_dict`, and dropped on exit. Any other model, a BN in
    train mode and bf16 weights run as outside. Entries nest: an inner
    exit leaves an outer fold in place."""
    pairs = [(conv, bn) for conv, bn in _conv_bn_pairs(model)
             if not bn.training and conv.weight.dtype == torch.float32
             ] if isinstance(model, ResNet) else []
    if not pairs:
        yield
        return
    convs, bns = zip(*pairs)
    with span("models.fold"):
        folded = fold_batch_norm(
            [c.weight for c in convs], [b.weight for b in bns], [b.bias for b in bns],
            [b.running_mean for b in bns], [b.running_var for b in bns], [b.eps for b in bns])
    token = _FOLDED.set({**_FOLDED.get(), **dict(zip(convs, folded))})
    try:
        yield
    finally:
        _FOLDED.reset(token)


def folds_in_force() -> dict:
    """conv → (weight, bias) of each BN folded here: the tensors that the
    `folded_batch_norm` entries around this point computed, which the
    convs' forwards read."""
    return _FOLDED.get()


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


class AlexNetDef(NamedTuple):
    image_channels: int = 1
    n_class: int = 2
    img_size: int = 64
    kernel: int = 3
    padding: int = 0  # the shipped config's 'valid'
    alpha: float = 0.2  # LeakyReLU slope
    iid_classes: tuple = ()
    activation: str = "LeakyReLU"  # or "ReLU" (reference get_activation)

    def class_to_idx(self) -> dict:
        """Sorted IiD class labels → logit columns (util_cnn.py:204-205)."""
        return {c: i for i, c in enumerate(sorted(self.iid_classes))}

    def conv_sizes(self) -> list:
        """Spatial size after each conv + pool (the reference takes it from a
        dry forward, util_cnn.py:207-235)."""
        s, sizes = self.img_size, []
        for _ in range(4):
            s = (s + 2 * self.padding - self.kernel + 1) // 2
            sizes.append(s)
        return sizes

    @property
    def to_linear(self) -> int:
        return 256 * self.conv_sizes()[-1] ** 2


class AlexNet(nn.Module):
    def __init__(self, d: AlexNetDef, *, device=None, dtype=None):
        super().__init__()
        if d.activation not in ("ReLU", "LeakyReLU"):
            # the reference's get_activation ValueError (util_cnn.py:54)
            raise ValueError(d.activation)
        kw = {"device": device, "dtype": dtype}
        self.d = d
        for i, (cin, cout) in enumerate(((d.image_channels, 32), (32, 64), (64, 128),
                                         (128, 256)), start=1):
            setattr(self, f"conv{i}", nn.Conv2d(cin, cout, d.kernel, 1, d.padding, **kw))
        self.fc1 = nn.Linear(d.to_linear, 256, **kw)
        self.fc2 = nn.Linear(256, 256, **kw)
        self.fc3 = nn.Linear(256, d.n_class, **kw)

    def _act(self, h: torch.Tensor) -> torch.Tensor:
        return torch.relu(h) if self.d.activation == "ReLU" else F.leaky_relu(h, self.d.alpha)

    def _dropout(self, h: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        if not self.training or generator is None:
            return h
        keep = torch.rand(h.shape, generator=generator, device=h.device) < 0.5
        return torch.where(keep, h / 0.5, torch.zeros_like(h))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """x [N, C, H, W] → logits [N, n_class]; dropout only in train mode
        with a `generator` (see the module's docstring)."""
        h = x
        for i in range(1, 5):
            conv = getattr(self, f"conv{i}")
            h = max_pool2d(self._act(conv2d(h, conv.weight, conv.bias, 1, self.d.padding)), 2)
        h = h.reshape(h.shape[0], -1)
        h = self._dropout(self._act(linear(h, self.fc1.weight, self.fc1.bias)), generator)
        h = self._dropout(self._act(linear(h, self.fc2.weight, self.fc2.bias)), generator)
        return linear(h, self.fc3.weight, self.fc3.bias)
