"""BatchNorm with torch's train and eval semantics (counterpart of
`gan_discovery_pso_tpu/ops/norm.py:35-90`).

- eval: normalise with the running statistics only, eps 1e-5;
- train: normalise with the batch's *biased* variance, and update the
  running statistics with the *unbiased* one, momentum 0.1 weighting the new
  batch (`running ← 0.9·running + 0.1·batch`), as `nn.BatchNorm2d` does.

Parameters and statistics are used in x's dtype, which the convs keep at
fp32 (`ops/conv.py`), as JAX's type promotion does for bf16 parameters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def batch_norm_eval(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """(x − mean)·rsqrt(var + eps)·scale + bias over NCHW, per channel."""
    t = x.dtype
    return F.batch_norm(x, running_mean.to(t), running_var.to(t), scale.to(t),
                        bias.to(t), training=False, eps=eps)


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor,
                     momentum: float = 0.1, eps: float = 1e-5) -> torch.Tensor:
    """Train-mode BN over NCHW: the batch statistics normalise, and the
    running statistics are updated IN PLACE (the JAX version returns new
    ones; a module's buffers are its state here). Differentiable in x, scale
    and bias."""
    return F.batch_norm(x, running_mean, running_var, scale, bias, training=True,
                        momentum=momentum, eps=eps)
