"""Tensorised particle swarms, batched over swarms (counterpart of
`gan_discovery_pso_tpu/pso/swarm.py`).

Every field carries a leading swarm axis B, where the JAX package vmaps one
swarm over classes: positions [B, N, d], p_best_val [B, N], g_best_val [B],
and so on. One swarm is B = 1.

Reference semantics kept (reference src/pso/util_pso.py, SURVEY.md §3.1):
- velocity naming swap: the `w_cognitive` term couples the GLOBAL best and
  the `w_social` term the PERSONAL best (:43-49);
- r1, r2 are scalars per particle-update, not per dimension (:45,47);
- personal best before the move; global best from the personal bests;
  `g_best_val` appends only on improvement and the first improvement
  overwrites the initial inf (:135-151);
- early stop needs i > 2, ≥ 3 recorded improvements and
  |g[-1] − g[-2]| < tol (:186-188); a stopped swarm's state freezes and its
  history rows after the stop hold NaN diagnostics (the masked loop);
- inertia w ← 0.99·w from iteration 2 when scheduled (:72-74, :178-179);
- init: pos ~ N(0, 1)^d, vel = (N(0, 1) − 0.5)/10 (:30-31); the
  pso-inverter's swarm starts from given (encoder) positions with random
  velocities (`swarm_init_from_positions`, util_pso.py:93-112).

Draws: torch cannot reproduce JAX's threefry streams, so the initial
positions and velocities and each iteration's r1/r2 are inputs of
`optimize`; `swarm_init` and `draw_uniforms` make them from a
`torch.Generator`, and parity tests inject the draws JAX made.
`optimize_resumable` (JAX `:298-372`) indexes the injected r1/r2 by the
state's own `iteration`, so a resumed run replays the single-shot one.

The loop has no host synchronisation: early stop is a mask, not a break.
So on the card the runners replay its iteration as CUDA graphs
(`pso/graphs.py`), on the same `pso_iteration` and `history_row`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from gan_discovery_pso_tpu_torch.core.config import PsoConfig
from gan_discovery_pso_tpu_torch.core.profiling import span
from gan_discovery_pso_tpu_torch.ops.kernels import swarm_update
from gan_discovery_pso_tpu_torch.ops.precision import highest_precision


class SwarmState(NamedTuple):
    positions: torch.Tensor  # [B, N, d]
    velocities: torch.Tensor  # [B, N, d]
    p_best_pos: torch.Tensor  # [B, N, d]
    p_best_val: torch.Tensor  # [B, N]
    g_best_pos: torch.Tensor  # [B, d]
    g_best_val: torch.Tensor  # [B] current best (inf before the first improvement)
    g_prev_val: torch.Tensor  # [B] previous appended best (for the tol check)
    g_improvements: torch.Tensor  # [B] int32 == len(reference g_best_val list)
    w_inertia: torch.Tensor  # [B] fp32, mutable under schedule_inertia
    iteration: torch.Tensor  # [B] int32, 1-based like the reference loop
    done: torch.Tensor  # [B] bool early-stop latch


class PsoHistory(NamedTuple):
    """Per-iteration records, [B, iters, ...]; rows past a swarm's stop
    repeat its final state and hold NaN diagnostics."""

    positions: torch.Tensor  # [B, T, N, d] after each move
    velocities: torch.Tensor  # [B, T, N, d] after each move
    fitness: torch.Tensor  # [B, T, N] at the pre-move positions
    mean_mse: torch.Tensor  # [B, T] mean pairwise Euclidean distance
    g_best_val: torch.Tensor  # [B, T] best value after the iteration
    g_best_dummy: torch.Tensor  # [B, T] this iteration's candidate (:151)
    active: torch.Tensor  # [B, T] bool, False once early-stopped


def state_from_positions(positions: torch.Tensor, velocities: torch.Tensor,
                         w_inertia: float) -> SwarmState:
    """The initial state of B swarms from positions/velocities [B, N, d]."""
    b, n, d = positions.shape
    kw = {"device": positions.device}
    positions = positions.float()
    return SwarmState(
        positions=positions,
        velocities=velocities.float(),
        p_best_pos=positions,
        p_best_val=torch.full((b, n), torch.inf, **kw),
        g_best_pos=torch.zeros((b, d), **kw),
        g_best_val=torch.full((b,), torch.inf, **kw),
        g_prev_val=torch.full((b,), torch.inf, **kw),
        g_improvements=torch.ones((b,), dtype=torch.int32, **kw),  # reference starts [inf]
        w_inertia=torch.full((b,), w_inertia, **kw),
        iteration=torch.ones((b,), dtype=torch.int32, **kw),
        done=torch.zeros((b,), dtype=torch.bool, **kw),
    )


def swarm_init(rng: torch.Generator, n_swarms: int, n_particles: int,
               dim_space: int, w_inertia: float, device=None) -> SwarmState:
    """Random init matching Particle.__init__ (util_pso.py:30-37), drawn from
    `rng` on `device` (rng must live on that device)."""
    shape = (n_swarms, n_particles, dim_space)
    positions = torch.randn(shape, generator=rng, device=device)
    velocities = (torch.randn(shape, generator=rng, device=device) - 0.5) / 10.0
    return state_from_positions(positions, velocities, w_inertia)


def swarm_init_from_positions(rng: torch.Generator | None, positions: torch.Tensor,
                              w_inertia: float,
                              velocities: torch.Tensor | None = None) -> SwarmState:
    """Encoder-seeded init (JAX `:84`): the given positions [B, N, d] (one
    per OoD slice), velocities (N(0, 1) − 0.5)/10 drawn from `rng` on the
    positions' device, or the given ones (parity tests inject JAX's)."""
    if velocities is None:
        velocities = (torch.randn(positions.shape, generator=rng,
                                  device=positions.device) - 0.5) / 10.0
    return state_from_positions(positions, velocities.to(positions.device), w_inertia)


def draw_uniforms(rng: torch.Generator, n_iterations: int, n_swarms: int,
                  n_particles: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(r1, r2), each U[0, 1) of shape [iters, B, N]."""
    shape = (n_iterations, n_swarms, n_particles)
    return (torch.rand(shape, generator=rng, device=device),
            torch.rand(shape, generator=rng, device=device))


def mean_pairwise_distance(positions: torch.Tensor) -> torch.Tensor:
    """[B, N, d] → [B]: mean Euclidean distance over unordered particle
    pairs, the reference's O(N²) 'mse' diagnostic (util_pso.py:76-86), by
    the same ‖a‖² + ‖b‖² − 2a·b formula as the JAX package, its product in
    full fp32 under `--fast-math` too, as the JAX package's HIGHEST: with
    TF32 the product's rounding, ~1e-3 of ‖a‖², would swamp the distance of
    two nearby particles."""
    n = positions.shape[1]
    sq = (positions * positions).sum(dim=2)
    with highest_precision():
        cross = torch.bmm(positions, positions.transpose(1, 2))
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * cross
    d2 = torch.clamp(d2, min=0.0)
    mask = 1.0 - torch.eye(n, dtype=positions.dtype, device=positions.device)
    return (torch.sqrt(d2) * mask).sum(dim=(1, 2)) / (n * (n - 1))


def inertia(state: SwarmState, hp: PsoConfig) -> torch.Tensor:
    """This iteration's w [B]: 0.99·w from iteration 2 when scheduled."""
    w = state.w_inertia
    if hp.schedule_inertia:
        w = torch.where(state.iteration > 1, 0.99 * w, w)
    return w


def advance(state: SwarmState, up, p_best_pos: torch.Tensor, p_best_val: torch.Tensor,
            w: torch.Tensor, hp: PsoConfig) -> SwarmState:
    """The state after an update `up` (positions, velocities and the g-best
    fields, with `g_appended`): the improvement count, the iteration and the
    early-stop latch, whose operands are all per swarm."""
    g_improvements = state.g_improvements + up.g_appended.to(torch.int32)
    done = state.done
    if hp.early_stopping:
        tol_hit = torch.abs(up.g_best_val - up.g_prev_val) < hp.tolerance
        done = done | ((state.iteration > 2) & (g_improvements > 2) & tol_hit)
    return SwarmState(up.positions, up.velocities, p_best_pos, p_best_val,
                      up.g_best_pos, up.g_best_val, up.g_prev_val,
                      g_improvements, w, state.iteration + 1, done)


def pso_iteration(state: SwarmState, fitness: torch.Tensor, r1: torch.Tensor,
                  r2: torch.Tensor, hp: PsoConfig) -> SwarmState:
    """One PSO update of B swarms given the fitness [B, N] at the current
    positions; r1, r2 [B, N]. The update chain is the fused kernel
    (`ops/kernels/swarm_update.py`); inertia and early stop stay here."""
    w = inertia(state, hp)
    up = swarm_update(
        state.positions, state.velocities, state.p_best_pos, state.p_best_val,
        fitness, r1, r2, state.g_best_pos, state.g_best_val, state.g_prev_val,
        w, hp.w_cognitive, hp.w_social)
    return advance(state, up, up.p_best_pos, up.p_best_val, w, hp)


def _freeze(done: torch.Tensor, old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    return torch.where(done.view(-1, *([1] * (new.dim() - 1))), old, new)


def freeze(done: torch.Tensor, old: SwarmState, new: SwarmState) -> SwarmState:
    """`new`, but `old` for the swarms already done (the reference breaks
    out of its loop)."""
    return SwarmState(*(_freeze(done, o, n) for o, n in zip(old, new)))


def history_row(state: SwarmState, new: SwarmState, fitness: torch.Tensor) -> tuple:
    """(the state after an iteration: `new`, or `state` for the swarms
    already done; the iteration's `PsoHistory` fields, each without its T
    axis), given the state before it, the update `new` and the fitness
    [B, N] it scored."""
    dummy = torch.amin(new.p_best_val, dim=1)
    mmse = mean_pairwise_distance(new.positions)
    done = state.done
    state = freeze(done, state, new)
    return state, (state.positions, state.velocities, fitness,
                   torch.where(done, torch.nan, mmse), state.g_best_val,
                   torch.where(done, torch.nan, dummy), ~done)


def optimize(
    fitness_fn: Callable[[torch.Tensor], torch.Tensor],
    hp: PsoConfig,
    init_state: SwarmState,
    r1: torch.Tensor,
    r2: torch.Tensor,
    n_iterations: int | None = None,
) -> tuple[SwarmState, PsoHistory, SwarmState]:
    """Run B swarms for n_iterations (default hp.n_iterations).

    fitness_fn: positions [B, N, d] → values [B, N]. r1, r2: [iters, B, N].
    Returns (final_state, history, init_state). Spans: pso.iteration, and
    in it pso.fitness, pso.update and pso.history; pso.stack after."""
    n_iters = hp.n_iterations if n_iterations is None else n_iterations
    state = init_state
    if n_iters == 0:
        return state, _empty_history(state), init_state
    records = []
    for it in range(n_iters):
        with span("pso.iteration"):
            with span("pso.fitness"):
                fitness = fitness_fn(state.positions)
            with span("pso.update", device_time=True):
                new = pso_iteration(state, fitness, r1[it], r2[it], hp)
            with span("pso.history", device_time=True):
                state, record = history_row(state, new, fitness)
                records.append(record)
    with span("pso.stack"):
        history = PsoHistory(*(torch.stack(field, dim=1) for field in zip(*records)))
    return state, history, init_state


def _empty_history(state: SwarmState) -> PsoHistory:
    """A 0-iteration history of the state's swarms."""
    b, n, d = state.positions.shape
    kw = {"device": state.positions.device}
    return PsoHistory(torch.empty((b, 0, n, d), **kw), torch.empty((b, 0, n, d), **kw),
                      torch.empty((b, 0, n), **kw), torch.empty((b, 0), **kw),
                      torch.empty((b, 0), **kw), torch.empty((b, 0), **kw),
                      torch.empty((b, 0), dtype=torch.bool, **kw))


def _host_bools(x, n: int) -> np.ndarray:
    if x is None:
        return np.zeros(n, bool)
    return np.asarray(x.cpu() if torch.is_tensor(x) else x, bool).reshape(n)


def optimize_resumable(
    fitness_fn: Callable[[torch.Tensor], torch.Tensor],
    hp: PsoConfig,
    init_state: SwarmState,
    r1: torch.Tensor,
    r2: torch.Tensor,
    checkpointer=None,
    checkpoint_every: int = 10,
    tag: str = "swarm",
) -> tuple[SwarmState, PsoHistory, SwarmState]:
    """Preemption-safe `optimize`: runs in chunks of `checkpoint_every`
    iterations and saves the whole swarm state through `checkpointer`
    (`core.checkpoint.Checkpointer`) after each. With a saved
    `checkpoint_{tag}.msgpack` it resumes from it, not from `init_state`.

    r1, r2 are the single-shot run's draws, [n_iterations, B, N]; a chunk
    takes the rows from the state's own `iteration` on (one less than the
    iteration it starts with), so the resumed trajectory is the single-shot
    one. Returns (final_state, history, init_state) like `optimize`, the
    history covering the iterations run in this call (0 rows when resuming a
    finished run)."""
    device = init_state.positions.device
    state = init_state
    if checkpointer is not None:
        saved = checkpointer.try_load(f"checkpoint_{tag}.msgpack")
        if saved is not None:
            # field-name keyed, never dict-order dependent
            state = SwarmState(**{f: torch.as_tensor(saved["state"][f]).to(device)
                                  for f in SwarmState._fields})
    start = state
    parts = []
    done_iters = int(state.iteration.max()) - 1
    while done_iters < hp.n_iterations and not bool(state.done.all()):
        chunk = min(checkpoint_every, hp.n_iterations - done_iters)
        rows = slice(done_iters, done_iters + chunk)
        state, hist, _ = optimize(fitness_fn, hp, state, r1[rows], r2[rows], n_iterations=chunk)
        parts.append(hist)
        done_iters += chunk
        if checkpointer is not None:
            checkpointer.save_every_epoch(tag, done_iters, state._asdict())
    if not parts:
        return state, _empty_history(state), start
    history = PsoHistory(*(torch.cat(field, dim=1) for field in zip(*parts)))
    return state, history, start


def last_iteration(history: PsoHistory, done=None, state_iteration=None) -> list[int]:
    """The reference's returned `i`, per swarm: n_iterations + 1 on a natural
    exit, else the iteration whose tolerance check broke the loop
    (util_pso.py:174-189). Pass the final state's `done` to tell apart an
    early stop that latched on the last scheduled iteration.

    A 0-row history (`optimize_resumable` resuming a finished run) carries no
    signal: the answer then comes from `state_iteration`, the state's own
    counter, which sits at i + 1 after iteration i (0 without it)."""
    active = history.active.cpu().numpy()
    b = active.shape[0]
    done = _host_bools(done, b)
    if active.shape[1] == 0:
        if state_iteration is None:
            return [0] * b
        its = np.asarray(state_iteration.cpu() if torch.is_tensor(state_iteration)
                         else state_iteration, np.int64).reshape(b)
        return [int(it) - 1 if stopped else int(it) for it, stopped in zip(its, done)]
    out = []
    for act, stopped in zip(active, done):
        n_act = int(act.sum())
        out.append(n_act if (not act.all() or stopped) else n_act + 1)
    return out


@dataclasses.dataclass
class SwarmResult:
    """Host-side view of optimize()'s (state, history, init_state) for swarm
    b, with the reference's artifact contract."""

    state: SwarmState
    history: PsoHistory
    init_state: SwarmState
    hp: PsoConfig

    @property
    def g_best_pos(self) -> torch.Tensor:
        return self.state.g_best_pos

    @property
    def g_best_val(self) -> torch.Tensor:
        return self.state.g_best_val

    @property
    def last_iteration(self) -> list[int]:
        return last_iteration(self.history, done=self.state.done,
                              state_iteration=self.state.iteration)

    def swarm(self, b: int) -> "SwarmResult":
        """Swarm b alone, as a B = 1 result on the host: what `pso/io.py`
        and the stage's reports take (the JAX package's per-class
        `SwarmResult`)."""
        pick = lambda t: type(t)(*(x[b:b + 1].cpu() for x in t))  # noqa: E731
        return SwarmResult(pick(self.state), pick(self.history), pick(self.init_state), self.hp)

    def _active_count(self, b: int) -> int:
        return int(self.history.active[b].sum())

    def particle_trajectories(self, b: int = 0) -> np.ndarray:
        """[n_active + 1, N, d]: the initial and post-move positions of swarm
        b, the contents of Particle.history (util_pso.py:34-41)."""
        n_act = self._active_count(b)
        return np.concatenate([self.init_state.positions[b, None].cpu().numpy(),
                               self.history.positions[b, :n_act].cpu().numpy()])

    def velocity_trajectories(self, b: int = 0) -> np.ndarray:
        """[n_active + 1, N, d] ≡ Particle.history_vel (util_pso.py:36-37,50)."""
        n_act = self._active_count(b)
        return np.concatenate([self.init_state.velocities[b, None].cpu().numpy(),
                               self.history.velocities[b, :n_act].cpu().numpy()])

    def history_dict(self, b: int = 0) -> dict:
        """The reference optimize() history dict of swarm b
        (util_pso.py:173,182-184) plus the per-iteration candidate series:
        lists of np.float32, as the JAX package's (`overall_history.pkl`
        holds them)."""
        n_act = self._active_count(b)
        h = self.history
        series = lambda x: list(x[b, :n_act].cpu().numpy())  # noqa: E731
        return {
            "mean_mse": series(h.mean_mse),
            "global_best_val": series(h.g_best_val),
            "global_best_dummy": series(h.g_best_dummy),
        }
