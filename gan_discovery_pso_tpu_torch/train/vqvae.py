"""VQ-VAE training with a frozen pretrained-G decoder (counterpart of
`gan_discovery_pso_tpu/train/vqvae.py`: `VqvaeTrainState` :33,
`vqvae_init` :40, `make_vqvae_steps` :63, `train_vqvae` :104-166).

Reference loop src/inverter/utils_vq_vae/util_training.py:11-65, driven by
src/training/vq_vae.py:216-245: loss = MSE(x̃, x) + MSE(z_q, z_e detached)
+ β·MSE(z_e, z_q detached), β = 0.25; the decoder is the trained DCGAN G,
frozen; the best model by the val-OoD reconstruction loss (val IiD where
the OoD set is empty, then the train loss).

The JAX package freezes the decoder by zeroing its updates in an
`optax.multi_transform`; here its parameters take no gradient
(`load_frozen_decoder`) and the optimizer holds only the encoder and the
codebook, so Adam keeps no state for the decoder either way. The module is
updated in place; the best epoch's weights are kept as a cloned state
dict.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from gan_discovery_pso_tpu_torch.core.config import AdamConfig
from gan_discovery_pso_tpu_torch.models.vqvae import (
    VQVAEGan,
    VQVAEGanDef,
    load_frozen_decoder,
    vq_loss_terms,
)
from gan_discovery_pso_tpu_torch.train.common import make_optimizer, optimizer_step


@dataclasses.dataclass
class VqvaeTrainState:
    model: VQVAEGan
    opt: torch.optim.Optimizer


def vqvae_init(generator: torch.Generator, d: VQVAEGanDef, adam: AdamConfig, data_pso=None,
               frozen_gen: nn.Module | None = None, device=None) -> VqvaeTrainState:
    """The vqvae_dcgan model drawn from `generator` on the CPU (the codebook
    from `data_pso` where given), `frozen_gen` installed and frozen as its
    decoder, moved to `device`; the optimizer over what trains."""
    model = VQVAEGan(d, generator, data_pso=data_pso)
    if frozen_gen is not None:
        load_frozen_decoder(model, frozen_gen)
    model = model.to(device)
    trainable = [p for p in model.parameters() if p.requires_grad]
    return VqvaeTrainState(model, make_optimizer(adam, trainable))


def make_vqvae_steps(state: VqvaeTrainState, beta: float = 0.25):
    """(train_step, eval_step), each x [N, C, H, W] → {'loss', 'loss_recons',
    'loss_vq', 'loss_commit'} as 0-d tensors. train_step runs the model in
    train mode (the encoder's BN by the batch; a frozen decoder's by its
    running statistics) and takes one optimizer step; eval_step runs it in
    eval mode without gradients."""
    model, opt = state.model, state.opt
    params = [p for p in model.parameters() if p.requires_grad]

    def metrics(x) -> dict:
        x_tilde, z_e, z_q_bar, _idx = model(x)
        l_rec, l_vq, l_commit = vq_loss_terms(x, x_tilde, z_e, z_q_bar, beta)
        return {"loss": l_rec + l_vq + l_commit, "loss_recons": l_rec, "loss_vq": l_vq,
                "loss_commit": l_commit}

    def train_step(x: torch.Tensor) -> dict:
        model.train()
        m = metrics(x)
        optimizer_step(opt, params, m["loss"])
        return {k: v.detach() for k, v in m.items()}

    @torch.no_grad()
    def eval_step(x: torch.Tensor) -> dict:
        model.eval()
        return metrics(x)

    return train_step, eval_step


def _mean(values: list) -> float:
    """The fp32 mean of 0-d tensors, read in one transfer (NaN for none), as
    the JAX package's `float(jnp.mean(jnp.stack(...)))`."""
    return float(torch.stack(values).mean()) if values else float("nan")


def train_vqvae(state: VqvaeTrainState, train_batches, val_iid_batches, val_ood_batches,
                num_epochs: int, beta: float = 0.25, metrics_writer=None,
                report_cb=None) -> tuple[VqvaeTrainState, dict, int]:
    """The epoch loop (reference src/training/vq_vae.py:240-245). Each
    epoch: the train steps, the val-IiD and val-OoD evaluations, the
    history (the reference's key names, so that its figures read it),
    `report_cb(epoch, state)`, and the best weights by val-OoD
    reconstruction loss (an empty OoD set falls back to val IiD, then to the
    train loss). Returns (the state holding the best weights, the history,
    the best epoch)."""
    train_step, eval_step = make_vqvae_steps(state, beta)
    history = {"train_loss": [], "val_iid_loss": [], "val_ood_loss": [],
               "train_loss_recons": [], "train_loss_vq": [],
               "val_ood_loss_recons": [], "val_ood_loss_vq": []}
    best, best_epoch = float("inf"), 0
    best_state = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    for epoch in range(num_epochs):
        tm = [train_step(x) for x, _y in train_batches(epoch)]
        vi = [eval_step(x)["loss_recons"] for x, _y in val_iid_batches(epoch)]
        vom = [eval_step(x) for x, _y in val_ood_batches(epoch)]
        tr, viid = _mean([m["loss"] for m in tm]), _mean(vi)
        vood = _mean([m["loss_recons"] for m in vom])
        history["train_loss"].append(tr)
        history["val_iid_loss"].append(viid)
        history["val_ood_loss"].append(vood)
        history["train_loss_recons"].append(_mean([m["loss_recons"] for m in tm]))
        history["train_loss_vq"].append(_mean([m["loss_vq"] for m in tm]))
        history["val_ood_loss_recons"].append(vood)
        history["val_ood_loss_vq"].append(_mean([m["loss_vq"] for m in vom]))
        if metrics_writer is not None:
            metrics_writer.append(epoch, train_loss=tr, val_iid_loss=viid, val_ood_loss=vood)
        if report_cb is not None:
            report_cb(epoch, state)
        sel = next((v for v in (vood, viid, tr) if not math.isnan(v)), vood)
        if sel < best:
            best, best_epoch = sel, epoch
            best_state = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    state.model.load_state_dict(best_state)
    return state, history, best_epoch
