"""GAN quality metrics and the per-epoch evaluation (counterpart of
`gan_discovery_pso_tpu/evaluation/gan_eval.py`: `inception_score` :26,
`denoise_recon_loss` :36, `posterior_energy` / `posterior_variance`
:49-56, `GanEvalResult` :59, `evaluate_gan_epoch` :78).

The reference's evaluation (src/utils/util_dcgan.py:240-270) draws 12,800
batch-1 samples through a DataLoader and queries sklearn per image. Here
the samples come in chunks of 1280 from the sampler (`train/dcgan.py
make_sampler`, whose rescale is the B2 kernel's wrapper), the CAE encodes
each chunk, and FID, IS and the denoising loss are computed once over the
whole set, every forward in fp32 parity and eval mode.

Randomness: the z of every chunk, then the denoising noise, are drawn in
that order from one `generator`; tests inject `z` [n, z_dim, 1, 1] and
`noise` [n, C, H, W] (the JAX package's draws) instead.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn

from gan_discovery_pso_tpu_torch.evaluation.classifiers import KnnBattery, compute_posterior
from gan_discovery_pso_tpu_torch.evaluation.fid import fid_from_features
from gan_discovery_pso_tpu_torch.models.cae import add_noise
from gan_discovery_pso_tpu_torch.ops.precision import fp32_parity


def inception_score(p_yx: torch.Tensor, eps: float = 1e-16) -> torch.Tensor:
    """exp(E_x[KL(p(y|x) ‖ p(y))]) of the battery posterior (reference
    util_gan_evaluation.py:84-95)."""
    p_y = torch.mean(p_yx, dim=0, keepdim=True)
    kl = p_yx * (torch.log(p_yx + eps) - torch.log(p_y + eps))
    return torch.exp(torch.mean(torch.sum(kl, dim=1)))


@torch.no_grad()
def denoise_recon_loss(encoder: nn.Module, decoder: nn.Module, images: torch.Tensor,
                       noise_factor: float = 0.3, noise: torch.Tensor | None = None,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """The CAE's denoising reconstruction MSE over a batch (reference
    util_gan_evaluation.py:106-133, batched), modules in eval mode."""
    noisy = add_noise(images, noise_factor, noise=noise, generator=generator)
    with fp32_parity():
        rec = decoder(encoder(noisy))
    return torch.mean((rec - images) ** 2)


def posterior_energy(p_yx: torch.Tensor) -> torch.Tensor:
    """Σ_c p(c|x)² per image (reference util_gan_evaluation.py:161-162)."""
    return torch.sum(p_yx * p_yx, dim=1)


def posterior_variance(p_yx: torch.Tensor) -> torch.Tensor:
    """The population variance of p(c|x) over classes, per image
    (reference util_gan_evaluation.py:164-165)."""
    return torch.var(p_yx, dim=1, unbiased=False)


class GanEvalResult(NamedTuple):
    fid: torch.Tensor
    inception_score: torch.Tensor
    rec_loss_syn: torch.Tensor
    p_yx: torch.Tensor  # [N, C] battery posterior of the synthetic samples
    energy: torch.Tensor  # [N]
    variance: torch.Tensor  # [N]


@torch.no_grad()
def encode(encoder: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """CAE embeddings [N, latent], fp32 parity."""
    with fp32_parity():
        return encoder(images)


@torch.no_grad()
def evaluate_gan_epoch(
    sample_fn: Callable[..., torch.Tensor],
    encoder: nn.Module,
    decoder: nn.Module,
    battery: KnnBattery,
    real_images01: torch.Tensor,
    n_synthetic: int = 12800,
    noise_factor: float = 0.3,
    chunk: int = 1280,
    enc_real: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    z: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
) -> GanEvalResult:
    """The per-epoch evaluation (reference util_dcgan.py:240-270): sample
    `n_synthetic` images in chunks of `chunk` (`sample_fn(batch,
    generator=, z=)`), CAE-encode real and synthetic, FID, the battery
    posterior's IS, and the denoising loss on the synthetic images.

    real_images01: [M, C, H, W] in [0, 1]. enc_real: their embeddings, where
    the caller has them (the CAE is frozen over a GAN run, so a run encodes
    its val set once). The CAE runs in eval mode."""
    encoder.eval()
    decoder.eval()
    synthetic, emb_syn = [], []
    for i in range(0, n_synthetic, chunk):
        b = min(chunk, n_synthetic - i)
        imgs = sample_fn(b, generator=generator, z=None if z is None else z[i:i + b])
        synthetic.append(imgs)
        emb_syn.append(encode(encoder, imgs))
    synthetic = torch.cat(synthetic)
    enc_syn = torch.cat(emb_syn)
    if enc_real is None:
        enc_real = encode(encoder, real_images01)
    fid = fid_from_features(enc_real, enc_syn)
    p_yx = compute_posterior(battery, enc_syn)
    rec = denoise_recon_loss(encoder, decoder, synthetic, noise_factor, noise=noise,
                             generator=generator)
    return GanEvalResult(fid=fid, inception_score=inception_score(p_yx), rec_loss_syn=rec,
                         p_yx=p_yx, energy=posterior_energy(p_yx),
                         variance=posterior_variance(p_yx))
