"""Optimizers, losses and label smoothing of the port's training loops
(counterpart of `gan_discovery_pso_tpu/train/common.py`: `make_optimizer`
:17, `bce_from_logits` :43, `bce_on_probs` :49, `smooth_positive`/
`smooth_negative` :57-64, `cross_entropy_loss` :70), and the steps' two
helpers, `frozen` and `optimizer_step`.

The JAX package builds optax chains that reproduce torch's optimizers; here
they are torch's own:
- Adam: `optim.Adam` (lr, betas (beta1, beta2), eps);
- RMSprop: `optim.RMSprop` with torch's alpha 0.99 and eps outside the
  sqrt (the reference passes only lr/eps/weight_decay, util_dcgan.py:36-42);
- weight_decay: L2 added to the gradients, as both of them do it.

The GAN label smoothing (reference util_dcgan.py:77-83) draws from an
explicit `torch.Generator`: torch cannot replay threefry, so parity tests
feed the steps the targets the JAX package drew.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from gan_discovery_pso_tpu_torch.core.config import AdamConfig


def make_optimizer(cfg: AdamConfig, params, name: str | None = None) -> torch.optim.Optimizer:
    """The optimizer the config block names (`cfg.name`, or `name`) over
    `params`."""
    if name is None:
        name = cfg.name
    if name == "Adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.beta1, cfg.beta2),
                                eps=cfg.epsilon, weight_decay=cfg.weight_decay)
    if name == "RMSprop":
        return torch.optim.RMSprop(params, lr=cfg.lr, alpha=0.99, eps=cfg.epsilon,
                                   weight_decay=cfg.weight_decay)
    raise ValueError(name)


def make_capturable(optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """`optimizer` (Adam or RMSprop) switched in place to `capturable=True`,
    so that its step can be recorded in a CUDA graph: the step counts move
    to the parameters' device and the bias correction is computed there."""
    for group in optimizer.param_groups:
        group["capturable"] = True
    for p, st in optimizer.state.items():
        if torch.is_tensor(st.get("step")):
            st["step"] = st["step"].to(p.device, torch.float32)
    return optimizer


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy on int labels (torch CrossEntropyLoss)."""
    return F.cross_entropy(logits.float(), labels.long())


def bce_from_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of sigmoid(logits) in the stable form;
    targets may be soft and exceed 1 (the smoothed positives)."""
    return F.binary_cross_entropy_with_logits(logits, targets)


def bce_on_probs(probs: torch.Tensor, targets: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """BCE on probabilities, clipped to [eps, 1 − eps] (torch's BCELoss
    clamps its log terms at −100 instead)."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    return -torch.mean(targets * torch.log(p) + (1.0 - targets) * torch.log(1.0 - p))


def smooth_positive(generator: torch.Generator, shape, device=None) -> torch.Tensor:
    """class 1 → U[0.7, 1.2] (reference util_dcgan.py:77-81)."""
    return 0.7 + 0.5 * torch.rand(shape, generator=generator, device=device)


def smooth_negative(generator: torch.Generator, shape, device=None) -> torch.Tensor:
    """class 0 → U[0, 0.3] (reference util_dcgan.py:77-83)."""
    return 0.3 * torch.rand(shape, generator=generator, device=device)


@contextlib.contextmanager
def frozen(*modules: nn.Module):
    """requires_grad off for every parameter of `modules` (restored on
    exit): gradients still flow through them to their inputs."""
    params = [p for m in modules for p in m.parameters()]
    saved = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(params, saved):
            p.requires_grad_(flag)


def optimizer_step(optimizer: torch.optim.Optimizer, params: list, loss: torch.Tensor,
                   group=None) -> None:
    """One optimizer step on d loss / d params, computed for params only
    (`torch.autograd.grad`), so no other tensor's `.grad` changes. With a
    process group, `loss` is each rank's mean over its equal share of the
    batch, and the gradients are averaged over the group in one all-reduce:
    those of the mean over the whole batch."""
    grads = torch.autograd.grad(loss, params)
    if group is not None:
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat = flat / dist.get_world_size(group)
        grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
