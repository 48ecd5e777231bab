"""Seeded weights of a configuration's models, made on the device in a few
large calls.

One `torch.randn` per model fills a flat float32 buffer from a generator on
the run's device; every parameter is a scaled and shifted slice of it. The
result is a state dict under the reference repository's names, which the
benchmark loads into the measured program's modules and into the plain
reference alike. A scheme gives each leaf a normal draw of the spread its
initialisation would give:

- "dcgan": conv and transposed-conv weights N(0, 0.02), BatchNorm weights
  N(1, 0.02) (the DCGAN convention), BatchNorm biases 0;
- "glorot_normal": conv and linear weights N(0, 2 / (fan_in + fan_out)),
  BatchNorm weights 1 and biases 0;

and under both a bias of a conv or linear layer N(0, 1 / (3 fan_in)), the
variance of PyTorch's default U(±1/sqrt(fan_in)). BatchNorm running
statistics are 0 and 1.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_CONVS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def _fans(w: torch.Tensor) -> tuple[int, int]:
    """PyTorch's (fan_in, fan_out): dims 1 and 0 times the receptive field,
    for a transposed conv's (I, O, kH, kW) weight too."""
    field = math.prod(w.shape[2:])
    return w.shape[1] * field, w.shape[0] * field


def leaf_rules(model: nn.Module, scheme: str) -> list:
    """[(state-dict name, shape, mean, std)] for every floating-point
    parameter; buffers are left to `state_dict`."""
    rules = []
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(mod, _CONVS):
            w = mod.weight
            fan_in, fan_out = _fans(w)
            std = 0.02 if scheme == "dcgan" else math.sqrt(2.0 / (fan_in + fan_out))
            rules.append((prefix + "weight", tuple(w.shape), 0.0, std))
            if mod.bias is not None:
                rules.append((prefix + "bias", tuple(mod.bias.shape), 0.0,
                              1.0 / math.sqrt(3.0 * fan_in)))
        elif isinstance(mod, nn.BatchNorm2d):
            shape = tuple(mod.weight.shape)
            rules.append((prefix + "weight", shape, 1.0, 0.02 if scheme == "dcgan" else 0.0))
            rules.append((prefix + "bias", shape, 0.0, 0.0))
    return rules


def make_state_dict(model: nn.Module, scheme: str, generator: torch.Generator,
                    device) -> dict:
    """A state dict for `model` (any device, "meta" included) drawn from
    `generator` on `device` in one call, plus BatchNorm buffers."""
    if scheme not in ("dcgan", "glorot_normal"):
        raise ValueError(f"unknown weight scheme {scheme!r}")
    rules = leaf_rules(model, scheme)
    total = sum(math.prod(shape) for _, shape, _, _ in rules)
    flat = torch.randn(total, generator=generator, device=device)
    out, off = {}, 0
    for name, shape, mean, std in rules:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape).mul(std).add_(mean)
        off += n
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            out[name] = torch.zeros(buf.shape, device=device)
        elif name.endswith("running_var"):
            out[name] = torch.ones(buf.shape, device=device)
        elif name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.long, device=device)
    return out
