"""Optimizers and the classification loss of the port's training loops
(counterpart of `gan_discovery_pso_tpu/train/common.py`: `make_optimizer`
:17, `cross_entropy_loss` :70).

The JAX package builds optax chains that reproduce torch's optimizers; here
they are torch's own:
- Adam: `optim.Adam` (lr, betas (beta1, beta2), eps);
- RMSprop: `optim.RMSprop` with torch's alpha 0.99 and eps outside the
  sqrt (the reference passes only lr/eps/weight_decay, util_dcgan.py:36-42);
- weight_decay: L2 added to the gradients, as both of them do it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy on int labels (torch CrossEntropyLoss)."""
    return F.cross_entropy(logits.float(), labels.long())
