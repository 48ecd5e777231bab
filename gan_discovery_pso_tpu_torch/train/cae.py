"""CAE training (denoising or reconstruction) and the embedding sweep
(counterpart of `gan_discovery_pso_tpu/train/cae.py`: `make_cae_steps` :67,
`train_cae` :103, `encode_dataset` :131, `save_encoded_samples_csv` :144;
reference src/training/cae.py, src/evaluation/util_cae.py:168-281).

- the 'denoising' task corrupts the inputs with clipped Gaussian noise
  (noise_factor 0.3) before encoding; 'reconstruction' trains on clean
  ones;
- one Adam over the encoder's and the decoder's parameters, the loss the
  MSE of the reconstruction against the clean input;
- the model of the last epoch is the result (the reference saves
  encoder.pt/decoder.pt after the last epoch, cae.py:205-206);
- the noise of each train and then each val batch is drawn from one
  `generator` in order; parity tests feed the steps the JAX package's
  draws.

`save_encoded_samples_csv` writes the `var_0 … var_{d-1},label` CSV with
the standard library (the card's host has no pandas); its text equals
pandas' `DataFrame.to_csv(index=False)` of the float32 frame, which the
JAX package writes.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from gan_discovery_pso_tpu_torch.core.config import AdamConfig
from gan_discovery_pso_tpu_torch.models.cae import add_noise
from gan_discovery_pso_tpu_torch.ops.precision import fp32_parity
from gan_discovery_pso_tpu_torch.train.common import make_optimizer

TASKS = ("denoising", "reconstruction")


def make_cae_steps(encoder: nn.Module, decoder: nn.Module, optimizer: torch.optim.Optimizer,
                   task: str = "denoising", noise_factor: float = 0.3):
    """(train_step, eval_step), each (x, noise=None, generator=None) → the
    0-d MSE. `noise` is the N(0, 1) draw of x's shape for the denoising
    task (else drawn from `generator`); the reconstruction task takes none.
    train_step runs both modules in train mode and takes one optimizer
    step; eval_step runs them in eval mode without gradients."""
    if task not in TASKS:
        raise ValueError(task)

    def inputs(x, noise, generator):
        if task == "denoising":
            return add_noise(x, noise_factor, noise=noise, generator=generator)
        return x

    def train_step(x, noise=None, generator=None):
        encoder.train()
        decoder.train()
        optimizer.zero_grad(set_to_none=True)
        loss = torch.mean((decoder(encoder(inputs(x, noise, generator))) - x) ** 2)
        loss.backward()
        optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(x, noise=None, generator=None):
        encoder.eval()
        decoder.eval()
        return torch.mean((decoder(encoder(inputs(x, noise, generator))) - x) ** 2)

    return train_step, eval_step


def _epoch_mean(losses: list) -> float:
    """The mean of an epoch's 0-d losses, read in one transfer (NaN for
    none)."""
    if not losses:
        return float("nan")
    return float(torch.mean(torch.stack(losses)))


def train_cae(encoder: nn.Module, decoder: nn.Module, adam: AdamConfig, train_batches,
              val_batches, num_epochs: int, task: str = "denoising",
              noise_factor: float = 0.3, generator: torch.Generator | None = None,
              metrics_writer=None) -> dict:
    """Train both modules in place, in fp32 parity; returns the history
    {'train_loss', 'val_loss'} (per-epoch batch means). train_batches /
    val_batches: epoch → iterator of (x, y) on the modules' device;
    `generator` (on that device) draws the denoising noise."""
    optimizer = make_optimizer(adam, [*encoder.parameters(), *decoder.parameters()])
    train_step, eval_step = make_cae_steps(encoder, decoder, optimizer, task, noise_factor)
    history = {"train_loss": [], "val_loss": []}
    with fp32_parity():
        for epoch in range(num_epochs):
            tr = _epoch_mean([train_step(x, generator=generator)
                              for x, _y in train_batches(epoch)])
            va = _epoch_mean([eval_step(x, generator=generator) for x, _y in val_batches(epoch)])
            history["train_loss"].append(tr)
            history["val_loss"].append(va)
            if metrics_writer is not None:
                metrics_writer.append(epoch, train_loss=tr, val_loss=va)
    encoder.eval()
    decoder.eval()
    return history


@torch.no_grad()
def encode_dataset(encoder: nn.Module, images: torch.Tensor, chunk: int = 2048) -> np.ndarray:
    """[N, latent] CAE embeddings on the host (the encoded_samples CSV
    contract, reference util_cae.py:44-94): the encoder in eval mode, fp32
    parity, `chunk` images at a time."""
    encoder.eval()
    with fp32_parity():
        out = [encoder(images[i:i + chunk]).cpu().numpy()
               for i in range(0, images.shape[0], chunk)]
    if not out:
        return np.zeros((0, encoder.encoder_linear[2].out_features), np.float32)
    return np.concatenate(out, axis=0)


def _csv_float(x: np.float32) -> str:
    """One float32 cell as pandas writes it: numpy's shortest repr, an empty
    cell for NaN."""
    return "" if math.isnan(x) else str(x)


def save_encoded_samples_csv(path, embeddings: np.ndarray, labels) -> None:
    """`var_0,…,var_{d-1},label` rows (reference util_cae.py:66-72), the
    text of pandas' `to_csv(index=False)` of the float32 frame."""
    embeddings = np.asarray(embeddings, np.float32)
    labels = np.asarray(labels).astype(np.int64)
    header = ",".join([*(f"var_{i}" for i in range(embeddings.shape[1])), "label"])
    lines = [header]
    for row, label in zip(embeddings, labels):
        lines.append(",".join([*(_csv_float(v) for v in row), str(label)]))
    with open(path, "w", newline="") as f:
        f.write("\n".join(lines) + "\n")
