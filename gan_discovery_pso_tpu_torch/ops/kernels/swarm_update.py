"""Fused post-fitness swarm update: CUDA kernel `csrc/swarm_update.cu` and
its plain PyTorch version.

Counterpart of `gan_discovery_pso_tpu/ops/pallas/swarm_update.py`
(`pso_update_pallas`), batched over swarms: [B, N, d] with one CUDA block
per swarm, where the JAX package calls its kernel under a class vmap. The
inertia schedule and the early stop stay with the caller
(`pso/swarm.py:pso_iteration`), as in the JAX package.

The wrapper takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises. `swarm_update.launches` counts kernel
launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gan_discovery_pso_tpu_torch.ops.kernels import _build


class SwarmUpdate(NamedTuple):
    positions: torch.Tensor  # [B, N, d]
    velocities: torch.Tensor  # [B, N, d]
    p_best_pos: torch.Tensor  # [B, N, d]
    p_best_val: torch.Tensor  # [B, N]
    g_best_pos: torch.Tensor  # [B, d]
    g_best_val: torch.Tensor  # [B]
    g_prev_val: torch.Tensor  # [B]
    g_appended: torch.Tensor  # [B] bool: a real improvement (not the first)


def swarm_update_plain(pos, vel, p_best_pos, p_best_val, fitness, r1, r2,
                       g_best_pos, g_best_val, g_prev_val, w,
                       w_cognitive: float, w_social: float) -> SwarmUpdate:
    """The update chain of the JAX package's `pso_iteration`
    (`pso/swarm.py:136-164`) on a batch of swarms. w, g_best_val and
    g_prev_val are [B] tensors; r1, r2 are [B, N], scalar per particle."""
    improved = fitness < p_best_val
    pbv = torch.where(improved, fitness, p_best_val)
    pbp = torch.where(improved[..., None], pos, p_best_pos)
    cand = torch.argmin(pbv, dim=1)  # the first index wins a tie
    cand_val = pbv.gather(1, cand[:, None]).squeeze(1)
    cand_pos = pbp[torch.arange(pbp.shape[0], device=pbp.device), cand]
    g_improved = cand_val < g_best_val
    # list semantics: the first improvement overwrites inf and is not counted
    appended = g_improved & ~torch.isinf(g_best_val)
    gbv = torch.where(g_improved, cand_val, g_best_val)
    gbp = torch.where(g_improved[:, None], cand_pos, g_best_pos)
    gpv = torch.where(appended, g_best_val, g_prev_val)
    # the reference's naming swap: w_cognitive couples the GLOBAL best
    new_vel = (w[:, None, None] * vel
               + (w_cognitive * r1[..., None]) * (gbp[:, None, :] - pos)
               + (w_social * r2[..., None]) * (pbp - pos))
    return SwarmUpdate(pos + new_vel, new_vel, pbp, pbv, gbp, gbv, gpv, appended)


def _check(pos, args):
    b, n, d = pos.shape
    shapes = ((b, n, d), (b, n, d), (b, n), (b, n), (b, n), (b, n), (b, d),
              (b,), (b,), (b,))
    for t, shape in zip((pos, *args), ((b, n, d), *shapes)):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != pos.device or not t.is_contiguous()):
            raise ValueError(
                "swarm_update: expected contiguous fp32 tensors on one device "
                f"of shapes {[(b, n, d), *shapes]}; got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}")
    if n < 1:
        raise ValueError("swarm_update: a swarm needs at least one particle")


def swarm_update(pos, vel, p_best_pos, p_best_val, fitness, r1, r2,
                 g_best_pos, g_best_val, g_prev_val, w,
                 w_cognitive: float, w_social: float) -> SwarmUpdate:
    """One fused PSO update of B swarms; arguments as `swarm_update_plain`."""
    args = (vel, p_best_pos, p_best_val, fitness, r1, r2, g_best_pos,
            g_best_val, g_prev_val, w)
    if pos.device.type == "cpu":
        return swarm_update_plain(pos, *args, w_cognitive, w_social)
    if pos.device.type != "cuda":
        raise ValueError(f"swarm_update: unsupported device {pos.device}")
    _check(pos, args)
    b, n, d = pos.shape
    outs = SwarmUpdate(
        *(torch.empty_like(t) for t in (pos, vel, p_best_pos, p_best_val,
                                        g_best_pos, g_best_val, g_prev_val)),
        torch.empty((b,), dtype=torch.bool, device=pos.device))
    lib = _build.library()
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gdpt_swarm_update(
            *(t.data_ptr() for t in (pos, *args)),
            float(w_cognitive), float(w_social),
            *(t.data_ptr() for t in outs), b, n, d, stream)
    _build.check(err, "swarm_update")
    swarm_update.launches += 1
    return outs


swarm_update.launches = 0
