"""DCGAN adversarial training and the GAN evaluation's sampler (counterpart
of `gan_discovery_pso_tpu/train/dcgan.py`: `GanTrainState` :45, `gan_init`
:54, `make_gan_train_step` :74-157, `make_sampler` :191-205).

The train step reproduces the reference loop (src/utils/util_dcgan.py:
184-223) in this order:

1. fake = G(noise) in train mode: the step's ONE G forward, so G's BN
   running statistics move once (the JAX step forwards G twice and keeps
   the first forward's statistics, :117-118, :134-138);
2. the D step on fake detached: (BCE(D(real), ỹ₁) + BCE(D(fake), ỹ₀))/2
   with the label smoothing of `train/common.py`, then `opt_d.step()`;
3. the G step: BCE(D_new(fake), ỹ₁) against the ALREADY-UPDATED D (the
   reference steps D before the G backward), the same ỹ₁, through the
   first forward's graph.

Each step differentiates its loss for its own parameters only
(`optimizer_step`), so the G step leaves nothing in D's `.grad`, and D is
frozen while the G loss flows through it. The modules and optimizers are
updated in place; `GanTrainState` holds them and the step count, and
`compat/weights.py gan_train_state_tree` writes them in the JAX package's
checkpoint layout.

torch cannot replay threefry: a step takes its draws as a tensor triple
(noise [B, z, 1, 1], ỹ₁ [B], ỹ₀ [B]) or a `torch.Generator`, from which it
draws the noise, then the positives, then the negatives.

Data parallel (`group=`, a `torch.distributed` process group of W ranks):
each rank takes its 1/W of the global batch and of the draws, G's
train-mode BN takes its statistics over the global batch
(`ops.norm.sync_batch_norm`), and each step's gradients are all-reduced
into those of the global-batch mean loss, so every rank applies the same
update and reports the global losses. The state is broadcast from the
group's first rank when the step is made. This is the JAX package's step
under a data mesh (`tests/test_parallel.py:93`), which no stage of either
package runs.

Mixed precision (`compute_dtype=torch.bfloat16`, JAX :74-135): G and D
run on bf16 copies of their parameters made inside the step by a cast that
autograd differentiates (`torch.func.functional_call`), so the gradients
reach the fp32 master parameters in fp32, and Adam's state stays fp32. The
convs multiply in bf16 and return fp32 (`ops/conv.py`: bf16 activations
made the DCGAN's images constant, ROADMAP §C), so the BN batch statistics
are computed in fp32 and the running statistics are written back in fp32;
the logits and losses are fp32.

K steps as one program (`make_gan_train_scan_step`, JAX :160-188, which
scans K steps into one XLA program so that K − 1 dispatches disappear): on
the card the K steps are captured once as one `torch.cuda.CUDAGraph` over
static input buffers and replayed per call after the reals and the draws
are copied in, since the step at batch 128 is bound by the host's launches.
The optimizers step inside the graph, so the state's Adam or RMSprop is
switched to `capturable=True` (`train/common.py make_capturable`): its step
count lives on the card and its bias correction is computed there, which
the state's checkpoint tree reads and writes as before. Capture runs
warm-up steps for real, so the whole state (weights, BN statistics,
optimizer state, the step count) is snapshotted before and restored after;
a failed capture raises. The graph binds the state's tensors: replacing
them (`load_tree` after a scan) needs a new scan step. On the CPU the scan
is the plain loop of K eager steps. The data-parallel step is not scanned
(the JAX scan step never runs under a mesh; ROADMAP A21), and `run_dcgan`
keeps the eager step, as the JAX stage does.

The sampler: the reference synthesised ONE image per DataLoader item
(src/utils/util_data.py:422-445); here a batch of z goes through the frozen
generator in one forward, and each image is rescaled to [0, 1] by its own
min and max through the B2 kernel's wrapper (`ops/kernels/rescale.py`):
the CUDA kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from gan_discovery_pso_tpu_torch.compat.weights import (
    gan_train_state_tree,
    load_gan_train_state,
)
from gan_discovery_pso_tpu_torch.core.config import AdamConfig
from gan_discovery_pso_tpu_torch.models.dcgan import (
    Discriminator,
    DiscriminatorDef,
    Generator,
    GeneratorDef,
)
from gan_discovery_pso_tpu_torch.models.layers import dcgan_init_
from gan_discovery_pso_tpu_torch.ops.kernels import rescale01_per_sample
from gan_discovery_pso_tpu_torch.ops.norm import sync_batch_norm
from gan_discovery_pso_tpu_torch.ops.precision import fp32_parity
from gan_discovery_pso_tpu_torch.train.common import (
    bce_from_logits,
    frozen,
    make_capturable,
    make_optimizer,
    optimizer_step,
    smooth_negative,
    smooth_positive,
)

SCAN_WARMUP = 3  # steps run on a side stream before the capture, then undone


@dataclasses.dataclass
class GanTrainState:
    gen: Generator
    disc: Discriminator
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    step: int = 0

    def tree(self) -> dict:
        """The JAX package's `GanTrainState` checkpoint tree (host copies)."""
        return gan_train_state_tree(self.gen, self.disc, self.opt_g, self.opt_d, self.step)

    def load_tree(self, tree: dict) -> "GanTrainState":
        """Restore a `tree()` (or a JAX run's state) in place."""
        self.step = load_gan_train_state(tree, self.gen, self.disc, self.opt_g, self.opt_d)
        return self


def gan_init(generator: torch.Generator, gdef: GeneratorDef, ddef: DiscriminatorDef,
             adam: AdamConfig, device=None) -> GanTrainState:
    """G then D with the DCGAN init (N(0, 0.02) weights, torch-default
    biases) drawn from `generator` on the CPU, so the card and the CPU start
    alike; moved to `device`, each with the optimizer `adam` names."""
    gen = dcgan_init_(Generator(gdef), generator).to(device)
    disc = dcgan_init_(Discriminator(ddef), generator).to(device)
    return GanTrainState(gen, disc, make_optimizer(adam, list(gen.parameters())),
                         make_optimizer(adam, list(disc.parameters())))


def _draws(draw, bs: int, z_dim: int, real: torch.Tensor, label_smoothing: bool) -> tuple:
    """(noise, ỹ₁, ỹ₀): given ones on `real`'s device in its dtype, else
    drawn from the generator `draw`."""
    device = real.device
    if not isinstance(draw, torch.Generator):
        return tuple(t.to(device, real.dtype) for t in draw)
    noise = torch.randn((bs, z_dim, 1, 1), generator=draw, device=device)
    if not label_smoothing:
        return noise, torch.ones(bs, device=device), torch.zeros(bs, device=device)
    return (noise, smooth_positive(draw, (bs,), device),
            smooth_negative(draw, (bs,), device))


class _Method(nn.Module):
    """`module.<name>(*args)` as a forward, for `functional_call`."""

    def __init__(self, module: nn.Module, name: str):
        super().__init__()
        self.m = module
        self.name = name

    def forward(self, *args):
        return getattr(self.m, self.name)(*args)


def _in_dtype(module: nn.Module, name: str, dtype: torch.dtype | None) -> Callable:
    """`module.<name>`, or with a dtype the same method run on `dtype` casts
    of the module's parameters, made at each call and differentiated
    through; buffers (BN running statistics) stay the module's own."""
    method = getattr(module, name)
    if dtype is None:
        return method
    wrapper = _Method(module, name)

    def call(*args):
        params = {f"m.{k}": p.to(dtype) for k, p in module.named_parameters()}
        return torch.func.functional_call(wrapper, params, args)

    return call


def make_gan_train_step(state: GanTrainState, label_smoothing: bool = True, group=None,
                        compute_dtype: torch.dtype | None = None):
    """train_step(real [B, C, H, W], draw) → {'loss_gen', 'loss_disc'}, 0-d
    tensors on the device, one step of G and D in `state` (see the module
    docstring); `state.step` counts the steps. Without label smoothing the
    targets are 1 and 0 (a generator then draws the noise alone).
    compute_dtype=torch.bfloat16 is the mixed-precision step.

    With a process group, `real` and the draws are the GLOBAL batch's
    (every rank passes the same, or the same generator seed) and each rank
    steps on its slice."""
    gen, disc = state.gen, state.disc
    g_params, d_params = list(gen.parameters()), list(disc.parameters())
    z_dim = gen.gen[0][0].in_channels
    gen_fwd = _in_dtype(gen, "forward", compute_dtype)
    disc_logits = _in_dtype(disc, "logits", compute_dtype)
    if group is not None:
        _broadcast_modules((gen, disc), group)

    def train_step(real: torch.Tensor, draw) -> dict:
        noise, y_real, y_fake = _draws(draw, real.shape[0], z_dim, real, label_smoothing)
        if group is not None:
            real, noise, y_real, y_fake = _rank_slice((real, noise, y_real, y_fake), group)
        gen.train()
        with sync_batch_norm(group):
            fake = gen_fwd(noise)
        loss_d = (bce_from_logits(disc_logits(real), y_real)
                  + bce_from_logits(disc_logits(fake.detach()), y_fake)) / 2.0
        optimizer_step(state.opt_d, d_params, loss_d, group)
        with frozen(disc):
            loss_g = bce_from_logits(disc_logits(fake), y_real)
            optimizer_step(state.opt_g, g_params, loss_g, group)
        state.step += 1
        losses = torch.stack([loss_g.detach(), loss_d.detach()])
        if group is not None:
            dist.all_reduce(losses, group=group)
            losses = losses / dist.get_world_size(group)
        return {"loss_gen": losses[0], "loss_disc": losses[1]}

    return train_step


def make_gan_train_scan_step(state: GanTrainState, label_smoothing: bool = True,
                             compute_dtype: torch.dtype | None = None, group=None):
    """scan_step(reals [K, B, C, H, W], draws) → {'loss_gen': [K],
    'loss_disc': [K]}: K train steps of `make_gan_train_step` (same
    arguments) as one CUDA graph on the card, K eager steps on the CPU;
    `state.step` goes up by K. `draws` is a triple (noise [K, B, z, 1, 1],
    ỹ₁ [K, B], ỹ₀ [K, B]) or a `torch.Generator`, from which exactly what K
    calls of the step would draw is drawn, in the same order, outside the
    graph. A graph is captured at the first call of each input shape (see
    the module docstring)."""
    if group is not None:
        raise ValueError("make_gan_train_scan_step: no data-parallel scan (group=); the JAX "
                         "scan step never runs under a mesh (ROADMAP A21)")
    step = make_gan_train_step(state, label_smoothing, compute_dtype=compute_dtype)
    z_dim = state.gen.gen[0][0].in_channels

    def draws_of(draws, reals) -> tuple:
        if not isinstance(draws, torch.Generator):
            return tuple(t.to(reals.device, reals.dtype) for t in draws)
        rows = [_draws(draws, reals.shape[1], z_dim, real, label_smoothing) for real in reals]
        return tuple(torch.stack(col) for col in zip(*rows))

    def steps(reals, noise, y_real, y_fake) -> torch.Tensor:
        rows = []
        for i in range(reals.shape[0]):
            m = step(reals[i], (noise[i], y_real[i], y_fake[i]))
            rows.append(torch.stack([m["loss_gen"], m["loss_disc"]]))
        return torch.stack(rows)

    def losses(rows: torch.Tensor) -> dict:
        return {"loss_gen": rows[:, 0], "loss_disc": rows[:, 1]}

    if next(state.gen.parameters()).device.type != "cuda":
        def scan_step(reals: torch.Tensor, draws) -> dict:
            return losses(steps(reals, *draws_of(draws, reals)))

        return scan_step

    make_capturable(state.opt_g)
    make_capturable(state.opt_d)
    graphs = {}

    def scan_step(reals: torch.Tensor, draws) -> dict:
        inputs = (reals, *draws_of(draws, reals))
        key = tuple((tuple(t.shape), t.dtype) for t in inputs)
        if key not in graphs:
            graphs[key] = _capture_steps(state, steps, inputs)
        graph, static, out, bound = graphs[key]
        now = _state_tensors(state)
        if len(now) != len(bound) or any(a is not b for a, b in zip(now, bound)):
            raise RuntimeError("the GAN train state's tensors were replaced after the scan "
                               "step's graph was captured (load_tree does this): make a new "
                               "scan step")
        for dst, src in zip(static, inputs):
            dst.copy_(src)
        graph.replay()
        state.step += reals.shape[0]
        return losses(out.clone())

    return scan_step


def _state_tensors(state: GanTrainState) -> list:
    """Every tensor of the train state: parameters, buffers, optimizer
    state."""
    out = [*state.gen.parameters(), *state.gen.buffers(), *state.disc.parameters(),
           *state.disc.buffers()]
    for opt in (state.opt_g, state.opt_d):
        for st in opt.state.values():
            out += [v for v in st.values() if torch.is_tensor(v)]
    return out


def snapshot_state(state: GanTrainState):
    """What `restore_state` needs to put `state` back as it is now."""
    with torch.no_grad():
        saved = [(t, t.detach().clone()) for t in _state_tensors(state)]
    had = [{p for p in opt.state} for opt in (state.opt_g, state.opt_d)]
    return saved, had, state.step


def restore_state(state: GanTrainState, snapshot) -> None:
    """`state` as `snapshot_state` saw it, in place (the same tensors): the
    optimizer entries made since are zeroed, which is a fresh optimizer's
    state (zero moments, step 0)."""
    saved, had, step = snapshot
    with torch.no_grad():
        for t, value in saved:
            t.copy_(value)
        for opt, before in zip((state.opt_g, state.opt_d), had):
            for p, st in opt.state.items():
                if p not in before:
                    for v in st.values():
                        if torch.is_tensor(v):
                            v.zero_()
    state.step = step


def _capture_steps(state: GanTrainState, steps, inputs: tuple) -> tuple:
    """(graph, static inputs, static losses, the state's tensors): `steps`
    on static copies of `inputs` captured as one CUDA graph after
    SCAN_WARMUP warm-up calls on a side stream; the state as it was before
    the warm-up is restored whether the capture succeeds or fails."""
    static = [t.clone() for t in inputs]
    snapshot = snapshot_state(state)
    try:
        side = torch.cuda.Stream(static[0].device)
        side.wait_stream(torch.cuda.current_stream(static[0].device))
        with torch.cuda.stream(side):
            for _ in range(SCAN_WARMUP):
                steps(*static)
        torch.cuda.current_stream(static[0].device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = steps(*static)
        except Exception as e:
            raise RuntimeError(f"capturing {static[0].shape[0]} GAN steps as a CUDA graph "
                               f"failed: {e}") from e
    finally:
        restore_state(state, snapshot)
    return graph, static, out, _state_tensors(state)


def _broadcast_modules(modules, group) -> None:
    """Every parameter and buffer from the group's first rank."""
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for m in modules:
            for t in (*m.parameters(), *m.buffers()):
                dist.broadcast(t, src=src, group=group)


def _rank_slice(tensors, group) -> tuple:
    """This rank's 1/W of each tensor's leading (batch) axis."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n = tensors[0].shape[0]
    if n % world:
        raise ValueError(f"a global batch of {n} over {world} ranks")
    k = n // world
    return tuple(t[rank * k:(rank + 1) * k] for t in tensors)


def make_sampler(gen: nn.Module) -> Callable[..., torch.Tensor]:
    """sample(batch, generator=None, z=None) → [batch, C, H, W] in [0, 1]:
    G(z) in eval mode and fp32 parity, z [batch, z_dim, 1, 1] drawn from
    `generator` on G's device unless given."""
    z_dim = gen.gen[0][0].in_channels
    device = gen.gen[0][0].weight.device

    @torch.no_grad()
    def sample(batch: int, generator: torch.Generator | None = None,
               z: torch.Tensor | None = None) -> torch.Tensor:
        if z is None:
            z = torch.randn((batch, z_dim, 1, 1), generator=generator, device=device)
        with fp32_parity():
            return rescale01_per_sample(gen.eval()(z.to(device)))

    return sample
