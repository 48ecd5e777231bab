"""Convolutions with PyTorch's shape and padding semantics.

Counterpart of `gan_discovery_pso_tpu/ops/conv.py:57,154`. The JAX package
writes both ops on `lax.conv_general_dilated` to reproduce torch arithmetic;
here they are torch's own ops (cuDNN on the card). Layouts stay those of the
JAX package's public functions: NCHW activations, conv weight (O, I, kH, kW),
transposed-conv weight (I, O, kH, kW). The JAX package's alternate TPU
lowerings (`ops/conv.py:23-36`) compute the same values and are not ported.

Mixed precision follows the JAX package's fast-math recipe: the product runs
in the weights' dtype (x is cast to it), the result comes back as fp32 and
the bias is added in fp32, so activations between layers stay fp32. With
bf16 weights this matters: the DCGAN generator's images vary by ~1e-5 around
its bias, which bf16 activations would round away into constant images.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _finish(out: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    out = out.float()
    return out if bias is None else out + bias.float().reshape(1, -1, 1, 1)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           stride=1, padding=0) -> torch.Tensor:
    """torch.nn.functional.conv2d (NCHW, OIHW weight), fp32 out."""
    return _finish(F.conv2d(x.to(weight.dtype), weight, None, stride, padding), bias)


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor | None = None, stride=1, padding=0,
                     output_padding=0) -> torch.Tensor:
    """torch.nn.functional.conv_transpose2d (NCHW, IOHW weight), fp32 out."""
    return _finish(F.conv_transpose2d(x.to(weight.dtype), weight, None, stride,
                                      padding, output_padding), bias)
