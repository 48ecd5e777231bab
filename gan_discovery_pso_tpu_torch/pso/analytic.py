"""Analytic objectives for golden swarm tests (counterpart of
`gan_discovery_pso_tpu/pso/analytic.py:9,14,19`; reference
src/hands_on/example_pso.py:6-18 optimizes these with the minimal Swarm).

Each takes positions [B, N, d] and returns [B, N], row by row, so it is an
`optimize` fitness as it stands: the JAX versions take one particle [d]
and need `make_analytic_fitness` to vmap them. A row-wise fitness
gives each particle the same value whichever rows a call holds, so a
sharded run and an unsharded one see the same numbers
(`parallel/swarm_sharding.py`).
"""

from __future__ import annotations

import math

import torch


def sphere(x: torch.Tensor) -> torch.Tensor:
    """f(x) = Σ x_i², global minimum 0 at the origin."""
    return torch.sum(x * x, dim=-1)


def cosine_mixture(x: torch.Tensor) -> torch.Tensor:
    """f(x) = -0.1·Σ cos(5πx_i) + Σ x_i², min −0.1·d at the origin."""
    return -0.1 * torch.sum(torch.cos(5.0 * math.pi * x), dim=-1) + torch.sum(x * x, dim=-1)


def rastrigin(x: torch.Tensor) -> torch.Tensor:
    """Highly multimodal stress objective (not in the reference)."""
    return 10.0 * x.shape[-1] + torch.sum(x * x - 10.0 * torch.cos(2.0 * math.pi * x), dim=-1)

