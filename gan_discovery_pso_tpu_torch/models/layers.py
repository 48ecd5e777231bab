"""Linear layer and the seeded weight initialisations of the port's models.

Counterpart of `gan_discovery_pso_tpu/models/layers.py`. Layouts are torch's:
conv weight (O, I, kH, kW), transposed-conv weight (I, O, kH, kW), linear
weight (out, in). Every draw comes from the `torch.Generator` the caller
passes, so a seed fixes the weights (the JAX package draws from keys, which
torch cannot reproduce: parity tests carry weights across with
`compat/weights.py` instead).

Schemes (reference src/utils/util_dcgan.py:45-48, src/pso/util_cnn.py:65-79):
- DCGAN: N(0, 0.02) on conv, transposed-conv and BN weights; biases keep
  torch's default U(±1/sqrt(fan_in)); BN biases 0;
- the assessors' `model_cnn.network.cnn_initializer` (`cnn_init_`, the
  JAX package's `_WEIGHT_INITS`, layers.py:62-67): `glorot_normal`
  (xavier-normal), `glorot_uniform` (xavier-uniform), `he_normal`
  (kaiming-normal on fan-in, leaky-relu gain with a = 0), `random_normal`
  (N(0, 0.02)) or `torch_default` conv and linear weights; biases keep
  torch's default; BN weight 1, bias 0;
- `torch_default` linear (a re-headed assessor's new head,
  `change_classifier_head`): `nn.Linear`'s own kaiming-uniform weight and
  U(±1/sqrt(fan_in)) bias; `torch_default_init_` does the same to every
  conv of a model (the AttGAN encoder) and resets its BNs to weight 1,
  bias 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_CONVS = (nn.Conv2d, nn.ConvTranspose2d)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """x @ weight.T + bias, weight (out, in), in x's dtype: fp32 x with bf16
    weights runs in fp32, as JAX promotes `jnp.matmul` of the two."""
    t = x.dtype
    return F.linear(x, weight.to(t), None if bias is None else bias.to(t))


def _fan_in(weight: torch.Tensor) -> int:
    # torch's rule: dim 1 times the receptive field (for a transposed conv
    # (I, O, kH, kW) that is O·kH·kW)
    return weight.shape[1] * math.prod(weight.shape[2:])


def _default_bias_(bias: torch.Tensor, weight: torch.Tensor, generator: torch.Generator):
    bound = 1.0 / math.sqrt(_fan_in(weight))
    nn.init.uniform_(bias, -bound, bound, generator=generator)


def _reset_bn_(bn: nn.BatchNorm2d):
    nn.init.zeros_(bn.bias)
    bn.reset_running_stats()


@torch.no_grad()
def dcgan_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """N(0, 0.02) on conv/BN weights, torch-default conv biases, in place."""
    for m in model.modules():
        if isinstance(m, _CONVS):
            nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
            if m.bias is not None:
                _default_bias_(m.bias, m.weight, generator)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
            _reset_bn_(m)
    return model


_CNN_WEIGHT_INITS = {
    "random_normal": lambda w, g: nn.init.normal_(w, 0.0, 0.02, generator=g),
    "glorot_normal": lambda w, g: nn.init.xavier_normal_(w, generator=g),
    "glorot_uniform": lambda w, g: nn.init.xavier_uniform_(w, generator=g),
    "he_normal": lambda w, g: nn.init.kaiming_normal_(
        w, a=0.0, mode="fan_in", nonlinearity="leaky_relu", generator=g),
}
CNN_INITIALIZERS = ("torch_default", *_CNN_WEIGHT_INITS)


@torch.no_grad()
def cnn_init_(model: nn.Module, name: str, generator: torch.Generator) -> nn.Module:
    """The assessor initialisation `name` (one of CNN_INITIALIZERS) on every
    conv/linear weight, torch-default biases, identity BN, in place."""
    if name == "torch_default":
        return torch_default_init_(model, generator)
    if name not in _CNN_WEIGHT_INITS:
        raise ValueError(f"cnn_initializer {name!r}: one of {CNN_INITIALIZERS}")
    draw = _CNN_WEIGHT_INITS[name]
    for m in model.modules():
        if isinstance(m, (*_CONVS, nn.Linear)):
            draw(m.weight, generator)
            if m.bias is not None:
                _default_bias_(m.bias, m.weight, generator)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            _reset_bn_(m)
    return model


def glorot_normal_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Xavier-normal conv/linear weights, torch-default biases, identity BN,
    in place (`cnn_init_` with the shipped `glorot_normal`)."""
    return cnn_init_(model, "glorot_normal", generator)


@torch.no_grad()
def torch_default_linear_(layer: nn.Linear, generator: torch.Generator) -> nn.Linear:
    """`nn.Linear.reset_parameters` drawn from `generator`, in place."""
    nn.init.kaiming_uniform_(layer.weight, a=math.sqrt(5), generator=generator)
    if layer.bias is not None:
        _default_bias_(layer.bias, layer.weight, generator)
    return layer


@torch.no_grad()
def torch_default_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """torch's own conv/linear initialisation drawn from `generator`, BN
    weight 1 and bias 0, in place."""
    for m in model.modules():
        if isinstance(m, (*_CONVS, nn.Linear)):
            torch_default_linear_(m, generator)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            _reset_bn_(m)
    return model
