"""The swarm's plain semantics: the per-image min-max rescale, the
discovery and hybrid fitness, and one PSO update, after the reference
repository (src/pso/util_pso.py, src/pso/util_discovery.py).

- fitness: the assessor's softmax posterior of the swarm's class (a binary
  head: column 1), clipped at 1 after adding the threshold;
  optimize_in_training scores p + eps, optimize_out_training 1 - p + eps;
  the hybrid fitness adds w_rec times the pixel MSE between the patient's
  slice and the raw generator image, and eps once more;
- update: the personal best before the move (a particle improves on a
  strictly lower value), the global best from the personal bests (the first
  of equal values), the velocity's w_cognitive term pulling to the GLOBAL
  best and its w_social term to the PERSONAL best (the reference's naming),
  r1 and r2 one number per particle; the first improvement of the global
  best replaces its initial inf and is not counted as an appended value.
"""

from __future__ import annotations

import torch

OPTIMIZE_IN = "optimize_in_training"
OPTIMIZE_OUT = "optimize_out_training"


def rescale01(img: torch.Tensor) -> torch.Tensor:
    """[M, ...] → (x - min) / (max - min) per row, clamped to [0, 1]."""
    flat = img.reshape(img.shape[0], -1)
    lo = flat.amin(dim=1, keepdim=True)
    hi = flat.amax(dim=1, keepdim=True)
    return torch.clamp((flat - lo) / (hi - lo), 0.0, 1.0).reshape(img.shape)


def posterior(logits: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """[M, K] logits → [M] posterior of each row's class (column 1 when K <= 2)."""
    p = torch.softmax(logits, dim=1)
    if logits.shape[1] <= 2:
        return p[:, 1]
    return p.gather(1, classes.reshape(-1, 1)).reshape(-1)


def fitness(p: torch.Tensor, control: str, threshold: float, eps: float) -> torch.Tensor:
    p = torch.clamp(p + threshold, max=1.0)
    if control == OPTIMIZE_IN:
        return p + eps
    if control == OPTIMIZE_OUT:
        return (1.0 - p) + eps
    raise ValueError(control)


def hybrid_fitness(p: torch.Tensor, source: torch.Tensor, img: torch.Tensor, f: dict):
    """w_ass * fitness + w_rec * MSE(source, raw image) + eps, per row."""
    mse = torch.mean((source - img) ** 2, dim=tuple(range(1, img.dim())))
    return f["w_ass"] * fitness(p, f["control"], f["threshold"], f["eps"]) \
        + f["w_rec"] * mse + f["eps"]


def update(x, v, p_pos, p_val, f, r1, r2, g_pos, g_val, g_prev, w, c_cog, c_soc):
    """One update of B swarms: x, v, p_pos [B, N, d]; p_val, f, r1, r2
    [B, N]; g_pos [B, d]; g_val, g_prev, w [B]. Returns (x, v, p_pos,
    p_val, g_pos, g_val, g_prev) after it."""
    better = f < p_val
    p_val = torch.where(better, f, p_val)
    p_pos = torch.where(better[..., None], x, p_pos)
    best = torch.argmin(p_val, dim=1)
    cand_val = p_val.gather(1, best[:, None])[:, 0]
    cand_pos = p_pos[torch.arange(p_pos.shape[0], device=p_pos.device), best]
    g_better = cand_val < g_val
    appended = g_better & ~torch.isinf(g_val)
    g_prev = torch.where(appended, g_val, g_prev)
    g_val = torch.where(g_better, cand_val, g_val)
    g_pos = torch.where(g_better[:, None], cand_pos, g_pos)
    v = (w[:, None, None] * v
         + (c_cog * r1[..., None]) * (g_pos[:, None, :] - x)
         + (c_soc * r2[..., None]) * (p_pos - x))
    return x + v, v, p_pos, p_val, g_pos, g_val, g_prev
