"""Eval-mode BatchNorm (counterpart of `gan_discovery_pso_tpu/ops/norm.py:76`).

Normalises with the running statistics only, eps 1e-5, as torch's
`nn.BatchNorm2d` in eval mode. Parameters and statistics are used in x's
dtype, which the convs keep at fp32 (`ops/conv.py`), as JAX's type promotion
does for bf16 parameters. Train mode belongs to the training path.
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
