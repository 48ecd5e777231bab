"""DCGAN adversarial training and the GAN evaluation's sampler (counterpart
of `gan_discovery_pso_tpu/train/dcgan.py`: `GanTrainState` :45, `gan_init`
:54, `make_gan_train_step` :76-157, `make_sampler` :191-205).

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

`make_gan_train_scan_step` (:160, K steps as one XLA program) is not
ported: K calls of the step are the same computation, and the JAX package's
own test holds the two equal (`tests/test_train.py:456`).

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
    make_optimizer,
    optimizer_step,
    smooth_negative,
    smooth_positive,
)


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


def make_gan_train_step(state: GanTrainState, label_smoothing: bool = True, group=None):
    """train_step(real [B, C, H, W], draw) → {'loss_gen', 'loss_disc'}, 0-d
    tensors on the device, one step of G and D in `state` (see the module
    docstring); `state.step` counts the steps. Without label smoothing the
    targets are 1 and 0 (a generator then draws the noise alone).

    With a process group, `real` and the draws are the GLOBAL batch's
    (every rank passes the same, or the same generator seed) and each rank
    steps on its slice."""
    gen, disc = state.gen, state.disc
    g_params, d_params = list(gen.parameters()), list(disc.parameters())
    z_dim = gen.gen[0][0].in_channels
    if group is not None:
        _broadcast_modules((gen, disc), group)

    def train_step(real: torch.Tensor, draw) -> dict:
        noise, y_real, y_fake = _draws(draw, real.shape[0], z_dim, real, label_smoothing)
        if group is not None:
            real, noise, y_real, y_fake = _rank_slice((real, noise, y_real, y_fake), group)
        gen.train()
        with sync_batch_norm(group):
            fake = gen(noise)
        loss_d = (bce_from_logits(disc.logits(real), y_real)
                  + bce_from_logits(disc.logits(fake.detach()), y_fake)) / 2.0
        optimizer_step(state.opt_d, d_params, loss_d, group)
        with frozen(disc):
            loss_g = bce_from_logits(disc.logits(fake), y_real)
            optimizer_step(state.opt_g, g_params, loss_g, group)
        state.step += 1
        losses = torch.stack([loss_g.detach(), loss_d.detach()])
        if group is not None:
            dist.all_reduce(losses, group=group)
            losses = losses / dist.get_world_size(group)
        return {"loss_gen": losses[0], "loss_disc": losses[1]}

    return train_step


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
