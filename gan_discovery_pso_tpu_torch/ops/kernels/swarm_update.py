"""Fused post-fitness swarm update: CUDA kernel `csrc/swarm_update.cu` and
its plain PyTorch version.

Counterpart of `gan_discovery_pso_tpu/ops/pallas/swarm_update.py`
(`pso_update_pallas`), batched over swarms: [B, N, d] on a grid of
(particle tile, swarm), where the JAX package calls its kernel under a
class vmap. The inertia schedule and the early stop stay with the caller
(`pso/swarm.py:pso_iteration`), as in the JAX package.

The wrapper takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises. `swarm_update.launches` counts kernel
launches. `swarm_geometry` and `vector_path` are the pure-Python choices
of the launch: tile size and the float4 or scalar rows.

The split form, for a swarm whose particles are spread over ranks
(`parallel/swarm_sharding.py`): `swarm_pbest_local` (the personal best of
the shard's rows and the shard's global-best candidate) and `swarm_move`
(the g-best bookkeeping and the move, given the winner every rank holds
after the collective), each a kernel of the same `.cu` beside its plain
version, each with its own launch count. The halves over all shards equal
`swarm_update_plain` on the whole swarm, bit for bit.
"""

from __future__ import annotations

import functools
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


WARPS = 8  # warps per CTA: csrc/swarm_update.cu:kWarps (256 threads)
CTAS_PER_SM = 2
MAX_SWARMS = 65535  # the grid's y extent


def swarm_geometry(b: int, n: int, sms: int) -> int:
    """Particle rows per CTA of the grid (ceil(n / rows), b).

    Tile t covers rows [t*rows, min(n, (t+1)*rows)). Tiles hold a multiple
    of WARPS rows, so every warp walks as many rows, and are as large as
    still gives CTAS_PER_SM CTAs per SM over all b swarms, or one row per
    warp where the rows are too few for that: B = 1, N = 4096 gets 512 CTAs
    of 8 rows, the main path's [8, 32, .] 32 CTAs of 8."""
    tiles_wanted = -(-CTAS_PER_SM * sms // b)
    return WARPS * max(1, n // (tiles_wanted * WARPS))


def vector_path(d: int, row_ptrs) -> bool:
    """float4 rows when d % 4 == 0 and every [., d] row base (row_ptrs) is
    16-byte aligned; else scalar rows."""
    acc = 0
    for p in row_ptrs:
        acc |= p
    return d % 4 == 0 and acc % 16 == 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=64)
def _shapes(b, n, d):
    return ((b, n, d),) * 3 + ((b, n),) * 4 + ((b, d),) + ((b,),) * 3


def _check(pos, args):
    if pos.dim() != 3:
        raise ValueError(f"swarm_update: positions must be [B, N, d], got {tuple(pos.shape)}")
    b, n, d = pos.shape
    shapes = _shapes(b, n, d)
    index = pos.get_device()
    for t, shape in zip((pos, *args), shapes):
        if (t.shape != shape or t.dtype != torch.float32 or t.get_device() != index
                or not t.is_contiguous()):
            raise ValueError(
                "swarm_update: expected contiguous fp32 tensors on one device "
                f"of shapes {list(shapes)}; got {tuple(t.shape)} {t.dtype} on {t.device}")
    if n < 1:
        raise ValueError("swarm_update: a swarm needs at least one particle")
    if b > MAX_SWARMS:
        raise ValueError(f"swarm_update: at most {MAX_SWARMS} swarms in one launch, got {b}")


def swarm_update(pos, vel, p_best_pos, p_best_val, fitness, r1, r2,
                 g_best_pos, g_best_val, g_prev_val, w,
                 w_cognitive: float, w_social: float, *,
                 rows_per_cta: int | None = None) -> SwarmUpdate:
    """One fused PSO update of B swarms; arguments as `swarm_update_plain`.
    On the card the outputs are views of two fp32 buffers (and a bool one):
    few allocations, since the host's time per call is most of a launch's.
    `rows_per_cta` overrides `swarm_geometry`'s tile (a launch-geometry
    sweep); the CPU ignores it."""
    args = (vel, p_best_pos, p_best_val, fitness, r1, r2, g_best_pos,
            g_best_val, g_prev_val, w)
    dev = pos.device
    if dev.type == "cpu":
        return swarm_update_plain(pos, *args, w_cognitive, w_social)
    if dev.type != "cuda":
        raise ValueError(f"swarm_update: unsupported device {dev}")
    _check(pos, args)
    b, n, d = pos.shape
    big = pos.new_empty((3, b, n, d))
    small = pos.new_empty(b * d + b * n + 2 * b)
    appended = g_best_val.new_empty((b,), dtype=torch.bool)
    ptrs = [t.data_ptr() for t in (pos, *args)]
    big_ptr, small_ptr = big.data_ptr(), small.data_ptr()
    if rows_per_cta is None:
        rows_per_cta = swarm_geometry(b, n, _sm_count(dev.index))
    vec_d = vector_path(d, (ptrs[0], ptrs[1], ptrs[2], ptrs[7], big_ptr, small_ptr))
    err = _build.call(_build.library().gdpt_swarm_update, dev, *ptrs,
                      float(w_cognitive), float(w_social), big_ptr, small_ptr,
                      appended.data_ptr(), b, n, d, rows_per_cta, vec_d)
    _build.check(err, "swarm_update")
    swarm_update.launches += 1
    o_pos, o_vel, o_pbp = big.unbind(0)
    # the kernel's layout of `small`: g_best_pos | p_best_val | g_best_val | g_prev_val
    o_gbp, o_pbv, o_gbv, o_gpv = small.split_with_sizes((b * d, b * n, b, b))
    return SwarmUpdate(o_pos, o_vel, o_pbp, o_pbv.view(b, n), o_gbp.view(b, d),
                       o_gbv, o_gpv, appended)


swarm_update.launches = 0


class PbestLocal(NamedTuple):
    p_best_pos: torch.Tensor  # [B, n, d]
    p_best_val: torch.Tensor  # [B, n]
    candidate: torch.Tensor  # [B, d + 1]: the shard's best row, then its value
    cand_index: torch.Tensor  # [B] int32: its global index (row_offset + local)


class SwarmMove(NamedTuple):
    positions: torch.Tensor  # [B, n, d]
    velocities: torch.Tensor  # [B, n, d]
    g_best_pos: torch.Tensor  # [B, d]
    g_best_val: torch.Tensor  # [B]
    g_prev_val: torch.Tensor  # [B]
    g_appended: torch.Tensor  # [B] bool


def swarm_pbest_local_plain(pos, p_best_pos, p_best_val, fitness,
                            row_offset: int) -> PbestLocal:
    """The personal best of a shard's rows [B, n, d] and the shard's
    candidate for the global best: `swarm_update_plain`'s argmin order (NaN
    first, then the lowest value, then the lowest index), its index counted
    from the swarm's first row (the shard starts at `row_offset`)."""
    improved = fitness < p_best_val
    pbv = torch.where(improved, fitness, p_best_val)
    pbp = torch.where(improved[..., None], pos, p_best_pos)
    cand = torch.argmin(pbv, dim=1)
    row = pbp[torch.arange(pbp.shape[0], device=pbp.device), cand]
    candidate = torch.cat([row, pbv.gather(1, cand[:, None])], dim=1)
    return PbestLocal(pbp, pbv, candidate, (cand + row_offset).to(torch.int32))


def swarm_move_plain(pos, vel, p_best_pos, r1, r2, winner, g_best_pos, g_best_val,
                     g_prev_val, w, w_cognitive: float, w_social: float) -> SwarmMove:
    """`swarm_update_plain`'s g-best bookkeeping and move of a shard's rows,
    given the swarm's winner [B, d + 1] (its row, then its value)."""
    d = pos.shape[2]
    win_row, win_val = winner[:, :d], winner[:, d]
    g_improved = win_val < g_best_val
    appended = g_improved & ~torch.isinf(g_best_val)
    gbv = torch.where(g_improved, win_val, g_best_val)
    gbp = torch.where(g_improved[:, None], win_row, g_best_pos)
    gpv = torch.where(appended, g_best_val, g_prev_val)
    new_vel = (w[:, None, None] * vel
               + (w_cognitive * r1[..., None]) * (gbp[:, None, :] - pos)
               + (w_social * r2[..., None]) * (p_best_pos - pos))
    return SwarmMove(pos + new_vel, new_vel, gbp, gbv, gpv, appended)


MAX_MOVE_D = 58112  # the g-best row in dynamic shared memory: 227 KB


def _check_split(name, pos, tensors, shapes):
    if pos.dim() != 3:
        raise ValueError(f"{name}: positions must be [B, N, d], got {tuple(pos.shape)}")
    b, n, d = pos.shape
    index = pos.get_device()
    for t, shape in zip((pos, *tensors), shapes):
        if (t.shape != shape or t.dtype != torch.float32 or t.get_device() != index
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: expected contiguous fp32 tensors on one device of shapes "
                f"{list(shapes)}; got {tuple(t.shape)} {t.dtype} on {t.device}")
    if n < 1 or d < 1:
        raise ValueError(f"{name}: a shard needs at least one particle and one dimension")
    if b > MAX_SWARMS:
        raise ValueError(f"{name}: at most {MAX_SWARMS} swarms in one launch, got {b}")


def swarm_pbest_local(pos, p_best_pos, p_best_val, fitness, row_offset: int) -> PbestLocal:
    """The first half of the split update; arguments as
    `swarm_pbest_local_plain`. On the card the p_best outputs are views of
    one fp32 buffer."""
    dev = pos.device
    if dev.type == "cpu":
        return swarm_pbest_local_plain(pos, p_best_pos, p_best_val, fitness, row_offset)
    if dev.type != "cuda":
        raise ValueError(f"swarm_pbest_local: unsupported device {dev}")
    b, n, d = pos.shape
    _check_split("swarm_pbest_local", pos, (p_best_pos, p_best_val, fitness),
                 ((b, n, d),) * 2 + ((b, n),) * 2)
    out = pos.new_empty(b * n * d + b * n + b * (d + 1))
    idx = pos.new_empty((b,), dtype=torch.int32)
    o_pbp, o_pbv, o_cand = out.split_with_sizes((b * n * d, b * n, b * (d + 1)))
    rows_per_cta = swarm_geometry(b, n, _sm_count(dev.index))
    vec_d = vector_path(d, (pos.data_ptr(), p_best_pos.data_ptr(), out.data_ptr()))
    err = _build.call(_build.library().gdpt_swarm_pbest_local, dev, pos.data_ptr(),
                      p_best_pos.data_ptr(), p_best_val.data_ptr(), fitness.data_ptr(),
                      o_pbp.data_ptr(), o_pbv.data_ptr(), o_cand.data_ptr(), idx.data_ptr(),
                      b, n, d, int(row_offset), rows_per_cta, vec_d)
    _build.check(err, "swarm_pbest_local")
    swarm_pbest_local.launches += 1
    return PbestLocal(o_pbp.view(b, n, d), o_pbv.view(b, n), o_cand.view(b, d + 1), idx)


def swarm_move(pos, vel, p_best_pos, r1, r2, winner, g_best_pos, g_best_val, g_prev_val, w,
               w_cognitive: float, w_social: float) -> SwarmMove:
    """The second half of the split update; arguments as
    `swarm_move_plain`. On the card the outputs are views of two fp32
    buffers and a bool one."""
    args = (vel, p_best_pos, r1, r2, winner, g_best_pos, g_best_val, g_prev_val, w)
    dev = pos.device
    if dev.type == "cpu":
        return swarm_move_plain(pos, *args, w_cognitive, w_social)
    if dev.type != "cuda":
        raise ValueError(f"swarm_move: unsupported device {dev}")
    b, n, d = pos.shape
    _check_split("swarm_move", pos, args,
                 ((b, n, d),) * 3 + ((b, n),) * 2 + ((b, d + 1), (b, d)) + ((b,),) * 3)
    if d > MAX_MOVE_D:
        raise ValueError(f"swarm_move: d = {d} exceeds the {MAX_MOVE_D} floats of the "
                         "g-best row in shared memory")
    big = pos.new_empty((2, b, n, d))
    small = pos.new_empty(b * d + 2 * b)
    appended = g_best_val.new_empty((b,), dtype=torch.bool)
    rows_per_cta = swarm_geometry(b, n, _sm_count(dev.index))
    vec_d = vector_path(d, (pos.data_ptr(), vel.data_ptr(), p_best_pos.data_ptr(),
                            big.data_ptr()))
    err = _build.call(_build.library().gdpt_swarm_move, dev, pos.data_ptr(),
                      *(t.data_ptr() for t in args), float(w_cognitive), float(w_social),
                      big.data_ptr(), small.data_ptr(), appended.data_ptr(), b, n, d,
                      rows_per_cta, vec_d)
    _build.check(err, "swarm_move")
    swarm_move.launches += 1
    o_pos, o_vel = big.unbind(0)
    o_gbp, o_gbv, o_gpv = small.split_with_sizes((b * d, b, b))
    return SwarmMove(o_pos, o_vel, o_gbp.view(b, d), o_gbv, o_gpv, appended)


swarm_pbest_local.launches = 0
swarm_move.launches = 0
