"""Discovery runners, every class's swarm in one batch, and the pso-inverter's
runner (counterpart of `gan_discovery_pso_tpu/pso/runner.py:26-174,281`).

The JAX package vmaps `optimize` over a class axis (and an optional `stack`
axis of independent sweeps) inside one jitted program. Here both axes fold
into the written-out swarm axis B = stack·C: each iteration runs ONE
generator forward and ONE assessor forward over all B·N particles (or one per
particle chunk with `fitness_chunk`), one rescale launch and one swarm-update
launch.

Models are arguments of `run`, so one runner serves every set of weights.
`dtype=torch.bfloat16` runs the forwards on bf16 copies of the models (the
swarm math stays fp32); the default runs them in fp32 under
`ops.precision.fp32_parity`, the JAX package's `Precision.HIGHEST`.
Every runner's forwards run in `forward_scope`, which also folds the
assessor's eval BatchNorms into its convs for the length of a call
(`models.folded_batch_norm`, on the assessor itself, so hooks on it fire;
fp32 ResNets only, so the bf16 copies run their BNs).
Under a profiler session each call is a `runner.call` span, the root of
the swarm loop's and the fitness's (`core/profiling.py`), with the inputs,
draws and model casts in `runner.inputs`.

On the card, with the models as they are (fp32 parity or TF32), both
runners capture one iteration as CUDA graphs and replay them for every
later iteration and call (`pso/graphs.py`); the bf16 copies, the CPU and
every other loop run `optimize` eagerly.

`resolve_fitness_chunk` keeps the JAX package's rule for the
`trainer_pso.fitness_chunk` key, 'auto' included. The rule was measured on
a TPU (HBM streaming); on the card it only sets how many particles one
forward takes, and chunked fitness gives the values of the whole one.
`select_program` checks the `trainer_pso.program` key, which chooses
nothing here.

`make_inverter_runner` moves one encoder-seeded swarm (B = 1) on the same
`optimize`, with the hybrid fitness: each iteration launches the rescale
and the swarm-update kernel once, as discovery does.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from gan_discovery_pso_tpu_torch.core.config import PsoConfig
from gan_discovery_pso_tpu_torch.core.device import resolve_device
from gan_discovery_pso_tpu_torch.core.profiling import span
from gan_discovery_pso_tpu_torch.models.resnet import folded_batch_norm
from gan_discovery_pso_tpu_torch.ops.precision import cast_model, fp32_parity
from gan_discovery_pso_tpu_torch.pso.fitness import (
    OPTIMIZE_IN,
    OPTIMIZE_OUT,
    apply_discovery_fitness,
    inverter_fitness,
)
from gan_discovery_pso_tpu_torch.pso.graphs import IterationGraphs
from gan_discovery_pso_tpu_torch.pso.swarm import (
    SwarmState,
    draw_uniforms,
    swarm_init,
    swarm_init_from_positions,
)


def resolve_fitness_chunk(value, n_particles: int) -> int | None:
    """The `trainer_pso.fitness_chunk` key as a chunk size (JAX `:26`).

    'auto' or an absent key: 64 for swarms of ≥ 256 particles (when 64
    divides them), else none. An int: that chunk (validated); 0/false/null:
    none. The chunk only sets how many particles one forward takes: the
    values are those of the unchunked run."""
    if value in (None, "auto"):
        return 64 if n_particles >= 256 and n_particles % 64 == 0 else None
    if not value:
        return None
    v = int(value)
    if v <= 0 or n_particles % v:
        raise ValueError(
            f"fitness_chunk={v} must be positive and divide "
            f"n_particles={n_particles}")
    return v if v < n_particles else None


def select_program(program: str) -> None:
    """Check the `trainer_pso.program` key (JAX `:48`): auto, chunked or
    monolithic, else ValueError. The JAX package reads it to compile the
    sweep as 10-iteration programs or as one, for the TPU's compile times.
    The port compiles nothing, so every value runs the one loop of
    `make_batched_discovery_runner`."""
    if program not in ("auto", "chunked", "monolithic"):
        raise ValueError(f"trainer_pso.program={program!r} — expected "
                         "auto | chunked | monolithic")


def _on_device(model: nn.Module, device: torch.device, name: str):
    for p in model.parameters():
        if p.device.type != device.type or (
                device.index is not None and p.device.index != device.index):
            raise ValueError(f"{name} lives on {p.device}, the runner on {device}")


@contextlib.contextmanager
def forward_scope(assessor: nn.Module, dtype: torch.dtype | None):
    """What a runner's forwards run in: fp32 parity (none for `dtype`'s
    copies), inference mode, and `assessor`'s eval BatchNorms folded into
    its convs (`models.folded_batch_norm`)."""
    precision = fp32_parity() if dtype is None else contextlib.nullcontext()
    with precision, torch.inference_mode(), folded_batch_norm(assessor):
        yield


def make_batched_discovery_runner(
    hp: PsoConfig,
    control: str = OPTIMIZE_OUT,
    threshold: float = 0.0,
    eps: float = 0.1,
    dtype: torch.dtype | None = None,
    fitness_chunk: int | None = None,
    stack: int | None = None,
    device=None,
):
    """The batched multi-class sweep:

        run(gen_model, assessor, class_idxs [C], *, rng=None,
            init_state=None, r1=None, r2=None) → (final, history, init)

    with a leading swarm axis B = stack·C (swarm s·C + c is class c of stack
    member s). The draws are `init_state` (B swarms) and r1, r2
    [iters, B, N]; whatever is not given is drawn from `rng`, a
    `torch.Generator` on the runner's device.

    fitness_chunk: evaluate the fitness in sequential chunks of this many
    particles per swarm (must divide n_particles); the values are those of
    the unchunked run. device: the card (default); a host without CUDA
    raises unless a device such as "cpu" is named."""
    device = resolve_device(device)
    if fitness_chunk is not None and (fitness_chunk <= 0 or hp.n_particles % fitness_chunk):
        raise ValueError(
            f"fitness_chunk={fitness_chunk} must divide n_particles={hp.n_particles}")
    chunk = fitness_chunk if fitness_chunk and fitness_chunk < hp.n_particles else None
    graphs = IterationGraphs(hp, device, dtype)

    def run(gen_model: nn.Module, assessor: nn.Module, class_idxs, *,
            rng: torch.Generator | None = None, init_state: SwarmState | None = None,
            r1: torch.Tensor | None = None, r2: torch.Tensor | None = None):
        with span("runner.call"):
            with span("runner.inputs"):
                classes, init_state, r1, r2 = discovery_inputs(
                    hp, device, gen_model, assessor, class_idxs, stack, rng, init_state, r1,
                    r2)
                gen, cnn = cast_model(gen_model, dtype), cast_model(assessor, dtype)

            def make_fitness(closed):
                return rows_fitness(gen, cnn, closed["row_classes"], hp.n_particles, control,
                                    threshold, eps, dtype, chunk)

            closed = {"row_classes": classes.repeat_interleave(chunk or hp.n_particles)}
            with forward_scope(cnn, dtype):
                return graphs.optimize(make_fitness, closed, init_state, r1, r2, (gen, cnn))

    return run


def discovery_inputs(hp: PsoConfig, device: torch.device, gen_model: nn.Module,
                     assessor: nn.Module, class_idxs, stack: int | None = None, rng=None,
                     init_state: SwarmState | None = None, r1=None, r2=None) -> tuple:
    """A discovery runner's (classes [B], init_state, r1, r2) on `device`,
    B = stack·C: the models checked to live there, the draws not given
    drawn from `rng`."""
    _on_device(gen_model, device, "gen_model")
    _on_device(assessor, device, "assessor")
    classes = torch.as_tensor(class_idxs, dtype=torch.long, device=device).reshape(-1)
    if stack:
        classes = classes.repeat(stack)
    b = classes.numel()
    if (init_state is None or r1 is None or r2 is None) and rng is None:
        raise ValueError("pass rng, or init_state, r1 and r2")
    if init_state is None:
        init_state = swarm_init(rng, b, hp.n_particles, hp.dim_space, hp.w_inertia, device)
    if r1 is None or r2 is None:
        r1, r2 = draw_uniforms(rng, hp.n_iterations, b, hp.n_particles, device)
    return classes, init_state, r1.to(device), r2.to(device)


def discovery_fitness(gen: nn.Module, cnn: nn.Module, classes: torch.Tensor, n: int,
                      control: str, threshold: float, eps: float,
                      dtype: torch.dtype | None = None, chunk: int | None = None):
    """fitness(positions [B, n, d]) → [B, n], swarm b scored for class
    classes[b]: one generator and one assessor forward over all B·n
    particles, or one per `chunk` particles of each swarm."""
    return rows_fitness(gen, cnn, classes.repeat_interleave(chunk or n), n, control,
                        threshold, eps, dtype, chunk)


def rows_fitness(gen: nn.Module, cnn: nn.Module, row_classes: torch.Tensor, n: int,
                 control: str, threshold: float, eps: float,
                 dtype: torch.dtype | None = None, chunk: int | None = None):
    """`discovery_fitness` given the class of each row of a forward,
    row_classes [B·k] (k = chunk or n, swarm-major)."""
    k = chunk or n
    b = row_classes.numel() // k

    def fitness_rows(positions):  # [B, k, d] → [B, k]
        vals = apply_discovery_fitness(
            positions.reshape(b * k, -1), gen, cnn, row_classes,
            control=control, threshold=threshold, eps=eps, dtype=dtype)
        return vals.reshape(b, k)

    def fitness(positions):
        if chunk is None:
            return fitness_rows(positions)
        return torch.cat([fitness_rows(p.contiguous())
                          for p in positions.split(chunk, dim=1)], dim=1)

    return fitness


def make_discovery_runner(
    hp: PsoConfig,
    control: str = OPTIMIZE_OUT,
    threshold: float = 0.0,
    eps: float = 0.1,
    device=None,
):
    """One swarm: run(gen_model, assessor, class_idx, *, rng=None,
    init_state=None, r1=None, r2=None) → (final, history, init) with B = 1."""
    batched = make_batched_discovery_runner(hp, control, threshold, eps, device=device)

    def run(gen_model, assessor, class_idx: int, **draws):
        return batched(gen_model, assessor, [class_idx], **draws)

    return run


def make_inverter_runner(
    hp: PsoConfig,
    control: str = OPTIMIZE_IN,
    threshold: float = 0.0,
    eps: float = 0.1,
    w_ass: float = 1.0,
    w_rec: float = 1.0,
    dtype: torch.dtype | None = None,
    device=None,
):
    """The hybrid-inversion runner (JAX `:281`):

        run(gen_model, assessor, class_idx, source_images [N, C, H, W],
            init_positions [N, d], *, rng=None, init_state=None, r1=None,
            r2=None) → (final, history, init)

    one swarm (B = 1) whose particle i starts at init_positions[i] and is
    scored against source_images[i]. The draws are `init_state` (velocities
    included) and r1, r2 [iters, 1, N]; what is not given is drawn from
    `rng`, a `torch.Generator` on the runner's device. dtype=torch.bfloat16
    runs the forwards on bf16 copies of the models; the default runs them
    in fp32 parity. The models are arguments, so one runner serves every
    patient's fine-tuned assessor."""
    device = resolve_device(device)
    graphs = IterationGraphs(hp, device, dtype)

    def run(gen_model: nn.Module, assessor: nn.Module, class_idx: int, source_images,
            init_positions, *, rng: torch.Generator | None = None,
            init_state: SwarmState | None = None, r1: torch.Tensor | None = None,
            r2: torch.Tensor | None = None):
        with span("runner.call"):
            with span("runner.inputs"):
                _on_device(gen_model, device, "gen_model")
                _on_device(assessor, device, "assessor")
                if (init_state is None or r1 is None or r2 is None) and rng is None:
                    raise ValueError("pass rng, or init_state, r1 and r2")
                src = torch.as_tensor(source_images, dtype=torch.float32, device=device)
                if init_state is None:
                    pos = torch.as_tensor(init_positions, dtype=torch.float32, device=device)
                    init_state = swarm_init_from_positions(rng, pos[None], hp.w_inertia)
                n = init_state.positions.shape[1]
                if src.shape[0] != n:
                    raise ValueError(f"{src.shape[0]} source images for {n} particles")
                if r1 is None or r2 is None:
                    r1, r2 = draw_uniforms(rng, hp.n_iterations, 1, n, device)
                r1, r2 = r1.to(device), r2.to(device)
                gen = cast_model(gen_model, dtype)
                cnn = cast_model(assessor, dtype)

            def make_fitness(closed):
                def fitness(positions):  # [1, N, d] → [1, N]
                    return inverter_fitness(positions[0], gen, cnn, closed["source"],
                                            closed["class_idx"], control=control,
                                            threshold=threshold, eps=eps, w_ass=w_ass,
                                            w_rec=w_rec, dtype=dtype)[None]

                return fitness

            closed = {"source": src, "class_idx": class_idx}
            with forward_scope(cnn, dtype):
                return graphs.optimize(make_fitness, closed, init_state, r1, r2, (gen, cnn))

    return run
