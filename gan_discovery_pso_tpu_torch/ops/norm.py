"""BatchNorm with torch's train and eval semantics (counterpart of
`gan_discovery_pso_tpu/ops/norm.py:35-90`).

- eval: normalise with the running statistics only, eps 1e-5;
- train: normalise with the batch's *biased* variance, and update the
  running statistics with the *unbiased* one, momentum 0.1 weighting the new
  batch (`running ← 0.9·running + 0.1·batch`), as `nn.BatchNorm2d` does.

Parameters and statistics are used in x's dtype, which the convs keep at
fp32 (`ops/conv.py`), as JAX's type promotion does for bf16 parameters.

Data parallel: inside `sync_batch_norm(group)` train-mode BN takes its
statistics over the whole batch that the group's ranks hold between them,
as the JAX package's data-parallel step does (GSPMD all-reduces a mean
over a sharded batch axis): the sum, then the sum of squared deviations,
each all-reduced by a function whose backward all-reduces the gradient,
so that it reaches every rank's rows. The running statistics
move from those global statistics (the unbiased variance of the global
count), alike on every rank.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist
import torch.nn.functional as F

_SYNC_GROUP = contextvars.ContextVar("sync_batch_norm_group", default=None)


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
    and bias. Inside `sync_batch_norm(group)` the batch is the group's."""
    group = _SYNC_GROUP.get()
    if group is not None:
        return _batch_norm_synced(x, scale, bias, running_mean, running_var, momentum, eps,
                                  group)
    # bf16 parameters (the mixed-precision GAN step) meet fp32 activations:
    # the statistics and the running update stay in x's dtype
    return F.batch_norm(x, running_mean, running_var, scale.to(x.dtype), bias.to(x.dtype),
                        training=True, momentum=momentum, eps=eps)


@contextlib.contextmanager
def sync_batch_norm(group):
    """Train-mode BN inside takes its statistics over the batch of every
    rank of the process group `group` (None: this rank's batch)."""
    token = _SYNC_GROUP.set(group)
    try:
        yield
    finally:
        _SYNC_GROUP.reset(token)


class _GroupSum(torch.autograd.Function):
    """The sum of a tensor over the ranks of a group, whose gradient is the
    sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def _batch_norm_synced(x, scale, bias, running_mean, running_var, momentum, eps, group):
    dims, shape = (0, 2, 3), (1, -1, 1, 1)
    count = x.numel() // x.shape[1] * dist.get_world_size(group)
    mean = _GroupSum.apply(x.sum(dims), group) / count
    centred = x - mean.view(shape)
    var = _GroupSum.apply((centred * centred).sum(dims), group) / count
    with torch.no_grad():
        running_mean.mul_(1.0 - momentum).add_(momentum * mean)
        running_var.mul_(1.0 - momentum).add_(momentum * var * (count / (count - 1)))
    return (centred * torch.rsqrt(var + eps).view(shape) * scale.to(x.dtype).view(shape)
            + bias.to(x.dtype).view(shape))
