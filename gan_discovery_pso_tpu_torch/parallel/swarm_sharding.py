"""Sharded-swarm PSO: each swarm's particles split across ranks, the models
replicated (counterpart of `gan_discovery_pso_tpu/parallel/swarm_sharding.py`).

Rank i of a swarm axis of size W owns particles [i·N/W, (i+1)·N/W) of
every swarm it runs; an N that W does not divide raises. Per iteration, on
the rank's rows only:

    fitness → `swarm_pbest_local` (the personal best and the shard's
    candidate: its row, value and global index)
    → one all-reduce MIN over the swarm axis of an int64 key that orders
      (value, index) as `torch.argmin` does (NaN first, then the value, then
      the index): every rank learns the winner's index, so its rank
    → one all-reduce SUM of the candidate rows' bits, the winner's alone
      nonzero: every rank gets the winner's row and value bit for bit
      (a float SUM, as JAX `shardmap_swarm.py:93-95` does, would turn a
      -0.0 into +0.0)
    → `swarm_move` (the g-best bookkeeping and the move of the rank's rows).

The inertia schedule and the early-stop latch run on per-swarm values that
every rank of the swarm computes alike, so all freeze on one iteration.
r1, r2 are the whole swarm's [iters, B, N] draws, sliced by rank (JAX
`shardmap_swarm.py:69-74`), so with a row-wise fitness a sharded run is
bit-equal to `pso.optimize` on one rank. Positions, velocities and fitness
stay on their ranks until the end; one all-reduce then rebuilds every
array whole on every rank (`mesh.gather_blocks`), and the history's
`mean_mse` is computed from the gathered positions, as `optimize` computes
it from each iteration's. The returns are those of `pso.optimize`:
(final, history, init) with a leading swarm axis.

The 2-D runner (`make_batched_sharded_discovery_runner`) puts the classes
on one axis and each swarm's particles on the other; its collectives run
within a class's swarm group only (JAX `:161-170`). Its fitness is
`pso.fitness.apply_discovery_fitness` on the rank's rows, so the rescale
kernel (B2) takes each rank's shard. `make_multi_swarm_optimize` splits
whole swarms across ranks instead: they never communicate, and each rank
runs its swarms as one batch through the fused update.

`swarm_state_sharding` and `history_sharding` (JAX `:31,50`) say which
classes and rows of each field a rank owns, as index tuples into the whole
arrays; a field indexed by classes alone is held whole by every rank of
the class's swarm group.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gan_discovery_pso_tpu_torch.core.config import PsoConfig
from gan_discovery_pso_tpu_torch.ops.kernels import swarm_move, swarm_pbest_local
from gan_discovery_pso_tpu_torch.ops.precision import cast_model
from gan_discovery_pso_tpu_torch.parallel.mesh import Mesh, gather_blocks
from gan_discovery_pso_tpu_torch.pso.fitness import OPTIMIZE_OUT
from gan_discovery_pso_tpu_torch.pso.runner import (
    discovery_fitness,
    discovery_inputs,
    forward_scope,
)
from gan_discovery_pso_tpu_torch.pso.swarm import (
    PsoHistory,
    SwarmState,
    _empty_history,
    advance,
    freeze,
    inertia,
    mean_pairwise_distance,
    optimize,
)

_PARTICLE_FIELDS = ("positions", "velocities", "p_best_pos", "p_best_val")


class Layout(NamedTuple):
    """The swarms (classes) and particle rows a rank owns."""

    classes: slice
    rows: slice


def _part(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} {n} % mesh {parts} != 0")
    k = n // parts
    return slice(index * k, (index + 1) * k)


def layout(mesh: Mesh, n_swarms: int, n_particles: int, swarm_axis: str = "swarm",
           class_axis: str | None = None) -> Layout:
    """This rank's swarms (split over `class_axis`, all without one) and
    rows (split over `swarm_axis`, all without one)."""
    classes = (slice(0, n_swarms) if class_axis is None else
               _part(n_swarms, mesh.size(class_axis), mesh.index(class_axis), "n_swarms"))
    rows = (slice(0, n_particles) if swarm_axis is None else
            _part(n_particles, mesh.size(swarm_axis), mesh.index(swarm_axis), "n_particles"))
    return Layout(classes, rows)


def swarm_state_sharding(mesh: Mesh, n_particles: int, axis: str = "swarm",
                         n_swarms: int = 1, class_axis: str | None = None) -> SwarmState:
    """Each `SwarmState` field's index into the whole [B, N, ...] array that
    this rank owns: particle fields (classes, rows), per-swarm fields
    (classes,)."""
    cls, rows = layout(mesh, n_swarms, n_particles, axis, class_axis)
    return SwarmState(**{f: (cls, rows) if f in _PARTICLE_FIELDS else (cls,)
                         for f in SwarmState._fields})


def history_sharding(mesh: Mesh, n_particles: int, axis: str = "swarm",
                     n_swarms: int = 1, class_axis: str | None = None) -> PsoHistory:
    """Each `PsoHistory` field's index into the whole [B, T, N, ...] array
    that this rank holds while the swarm runs."""
    cls, rows = layout(mesh, n_swarms, n_particles, axis, class_axis)
    every = slice(None)
    return PsoHistory(positions=(cls, every, rows), velocities=(cls, every, rows),
                      fitness=(cls, every, rows), mean_mse=(cls,), g_best_val=(cls,),
                      g_best_dummy=(cls,), active=(cls,))


def order_key(value: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is `torch.argmin`'s over (value, index): NaN
    first, then the value (-0.0 ties +0.0), then the lower index."""
    s = value.contiguous().view(torch.int32).to(torch.int64)
    hi = torch.where(s >= 0, s, -(s & 0x7FFFFFFF))
    hi = torch.where(torch.isnan(value), torch.full_like(hi, -(2 ** 31)), hi)
    return hi * 2 ** 32 + index.to(torch.int64)


def global_best(local, n_loc: int, mesh: Mesh, axis: str) -> torch.Tensor:
    """The winner [B, d + 1] (row, then value) of each swarm over `axis`,
    from every rank's `swarm_pbest_local` output: two all-reduces."""
    if mesh.groups[axis] is None:
        return local.candidate
    key = mesh.all_reduce(order_key(local.candidate[:, -1], local.cand_index), "min", axis)
    winner_rank = torch.div(key & 0xFFFFFFFF, n_loc, rounding_mode="floor")
    bits = torch.where((winner_rank == mesh.index(axis))[:, None],
                       local.candidate.view(torch.int32), 0)
    return mesh.all_reduce(bits, "sum", axis).view(torch.float32)


def _take(state: SwarmState, lay: Layout) -> SwarmState:
    return SwarmState(**{f: (t[lay.classes, lay.rows] if f in _PARTICLE_FIELDS
                             else t[lay.classes]).contiguous()
                         for f, t in state._asdict().items()})


def _run_sharded(fitness_fn, hp: PsoConfig, init_state: SwarmState, r1, r2, mesh: Mesh,
                 swarm_axis: str, class_axis: str | None = None):
    """The loop of the module docstring on this rank's layout, then the
    whole (final, history, init) on every rank."""
    b, n, _d = init_state.positions.shape
    lay = layout(mesh, b, n, swarm_axis, class_axis)
    if hp.n_iterations == 0:
        return init_state, _empty_history(init_state), init_state
    state = _take(init_state, lay)
    r1 = r1[:, lay.classes, lay.rows].contiguous()
    r2 = r2[:, lay.classes, lay.rows].contiguous()
    n_loc = lay.rows.stop - lay.rows.start
    records = []
    for it in range(hp.n_iterations):
        fitness = fitness_fn(state.positions)
        w = inertia(state, hp)
        local = swarm_pbest_local(state.positions, state.p_best_pos, state.p_best_val,
                                  fitness, lay.rows.start)
        winner = global_best(local, n_loc, mesh, swarm_axis)
        moved = swarm_move(state.positions, state.velocities, local.p_best_pos, r1[it], r2[it],
                           winner, state.g_best_pos, state.g_best_val, state.g_prev_val, w,
                           hp.w_cognitive, hp.w_social)
        done = state.done
        state = freeze(done, state, advance(state, moved, local.p_best_pos,
                                            local.p_best_val, w, hp))
        records.append((state.positions, state.velocities, fitness, state.g_best_val,
                        torch.where(done, torch.nan, winner[:, -1]), ~done))
    return _assemble(state, records, init_state, lay, mesh, swarm_axis)


def _assemble(state: SwarmState, records, init_state: SwarmState, lay: Layout, mesh: Mesh,
              swarm_axis: str):
    b, n, d = init_state.positions.shape
    t = len(records)
    # one rank of each swarm group adds the fields every rank of it holds
    lead = swarm_axis is None or mesh.index(swarm_axis) == 0
    every = slice(None)
    parts = [(getattr(state, f), (lay.classes, lay.rows) if f in _PARTICLE_FIELDS
              else (lay.classes,), getattr(init_state, f).shape,
              f in _PARTICLE_FIELDS or lead) for f in SwarmState._fields]
    pos, vel, fit, gbv, dummy, active = (torch.stack(x, dim=1) for x in zip(*records))
    parts += [(pos, (lay.classes, every, lay.rows), (b, t, n, d), True),
              (vel, (lay.classes, every, lay.rows), (b, t, n, d), True),
              (fit, (lay.classes, every, lay.rows), (b, t, n), True)]
    parts += [(x, (lay.classes,), (b, t), lead) for x in (gbv, dummy, active)]
    whole = gather_blocks(parts, mesh)
    final = SwarmState(*whole[:len(SwarmState._fields)])
    pos, vel, fit, gbv, dummy, active = whole[len(SwarmState._fields):]
    mmse = torch.stack([mean_pairwise_distance(pos[:, i].contiguous()) for i in range(t)], 1)
    history = PsoHistory(pos, vel, fit, torch.where(active, mmse, torch.nan), gbv, dummy,
                         active)
    return final, history, init_state


def _on(state: SwarmState, device) -> SwarmState:
    return SwarmState(*(t.to(device) for t in state))


def make_sharded_optimize(mesh: Mesh, fitness_fn: Callable[[torch.Tensor], torch.Tensor],
                          hp: PsoConfig, axis: str = "swarm"):
    """`pso.optimize` with each swarm's particles split over `axis`:

        run(init_state, r1, r2) → (final, history, init)

    with the whole swarms' init_state [B, N, d] and r1, r2 [iters, B, N]
    on every rank (each takes its rows); fitness_fn maps the rank's
    positions [B, N/W, d] to [B, N/W]. Every rank gets the whole result."""
    _part(hp.n_particles, mesh.size(axis), 0, "n_particles")

    def run(init_state: SwarmState, r1: torch.Tensor, r2: torch.Tensor):
        return _run_sharded(fitness_fn, hp, _on(init_state, mesh.device),
                            r1.to(mesh.device), r2.to(mesh.device), mesh, axis)

    return run


def make_sharded_discovery_runner(mesh: Mesh, hp: PsoConfig, control: str = OPTIMIZE_OUT,
                                  threshold: float = 0.0, eps: float = 0.1,
                                  axis: str = "swarm", dtype: torch.dtype | None = None):
    """One class's swarm sharded over `axis` (JAX `:98`):

        run(gen_model, assessor, class_idx, *, rng=None, init_state=None,
            r1=None, r2=None) → (final, history, init), B = 1

    the models on the mesh's device, the draws as `pso.make_discovery_runner`
    takes them. One runner serves every class and every set of weights."""
    batched = make_batched_sharded_discovery_runner(
        mesh, hp, control, threshold, eps, dtype, class_axis=None, swarm_axis=axis)

    def run(gen_model, assessor, class_idx: int, **draws):
        return batched(gen_model, assessor, [class_idx], **draws)

    return run


def make_batched_sharded_discovery_runner(
    mesh: Mesh,
    hp: PsoConfig,
    control: str = OPTIMIZE_OUT,
    threshold: float = 0.0,
    eps: float = 0.1,
    dtype: torch.dtype | None = None,
    class_axis: str | None = "class",
    swarm_axis: str = "swarm",
):
    """Every class's swarm at once (`pso.make_batched_discovery_runner`),
    the classes split over `class_axis` and each swarm's particles over
    `swarm_axis` (JAX `:135`):

        run(gen_model, assessor, class_idxs [C], *, rng=None,
            init_state=None, r1=None, r2=None) → (final, history, init)

    with the whole [C, ...] arrays on every rank. dtype=torch.bfloat16 runs
    the forwards on bf16 copies of the models, the default fp32 parity; the
    assessor's eval BatchNorms are folded for a call, as the one-rank
    runner folds them (`pso.runner.forward_scope`)."""
    n_loc = _part(hp.n_particles, mesh.size(swarm_axis), 0, "n_particles").stop
    device = mesh.device

    def run(gen_model, assessor, class_idxs, *, rng: torch.Generator | None = None,
            init_state: SwarmState | None = None, r1: torch.Tensor | None = None,
            r2: torch.Tensor | None = None):
        classes, init_state, r1, r2 = discovery_inputs(
            hp, device, gen_model, assessor, class_idxs, None, rng, init_state, r1, r2)
        lay = layout(mesh, classes.numel(), hp.n_particles, swarm_axis, class_axis)
        cnn = cast_model(assessor, dtype)
        fitness = discovery_fitness(cast_model(gen_model, dtype), cnn, classes[lay.classes],
                                    n_loc, control, threshold, eps, dtype)
        with forward_scope(cnn, dtype):
            return _run_sharded(fitness, hp, _on(init_state, device), r1, r2, mesh,
                                swarm_axis, class_axis)

    return run


def make_multi_swarm_optimize(
    fitness_fn_batched: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    hp: PsoConfig,
    n_swarms: int,
    mesh: Mesh | None = None,
    axis: str = "swarm",
):
    """Independent swarms (one per IiD class or OoD patient, JAX `:218`),
    split whole across the ranks of `axis`:

        run(init_state, r1, r2) → (final, history, init)

    with every swarm's [S, N, d] state and [iters, S, N] draws on every
    rank. fitness_fn_batched(swarm_idxs [S_loc], positions [S_loc, N, d])
    → [S_loc, N] scores a rank's swarms (the JAX version is vmapped over
    one swarm's). Without a mesh, every swarm runs here as one batch."""
    parts = 1 if mesh is None else mesh.size(axis)
    _part(n_swarms, parts, 0, "n_swarms")

    def run(init_state: SwarmState, r1: torch.Tensor, r2: torch.Tensor):
        device = init_state.positions.device if mesh is None else mesh.device
        cls = slice(0, n_swarms) if mesh is None else _part(n_swarms, parts,
                                                            mesh.index(axis), "n_swarms")
        idx = torch.arange(cls.start, cls.stop, device=device)
        local = SwarmState(*(t[cls].to(device) for t in init_state))
        final, history, _ = optimize(lambda pos: fitness_fn_batched(idx, pos), hp, local,
                                     r1[:, cls].to(device), r2[:, cls].to(device))
        if mesh is None:
            return final, history, init_state
        whole = gather_blocks([(x, (cls,), (n_swarms, *x.shape[1:]), True)
                               for x in (*final, *history)], mesh, axis)
        k = len(SwarmState._fields)
        return SwarmState(*whole[:k]), PsoHistory(*whole[k:]), init_state

    return run
