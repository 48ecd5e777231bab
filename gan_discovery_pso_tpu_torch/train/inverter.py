"""GAN-inverter training and gradient-based latent optimisation (counterpart
of `gan_discovery_pso_tpu/train/inverter.py:1-530`).

Reference src/inverter/utils_ae/util_inverter.py:213-638 and
util_inverter_statistics.py:476-598:

- `make_pix_rec_step`: the encoder E trained by pixel MSE through the frozen
  generator G (:213-293);
- `make_pix_fea_rec_adv_step`: E and a discriminator D trained
  adversarially, with R1 on real samples (`r1_penalty`, a gradient of a
  gradient, :304-320) and perceptual features from the frozen assessor's
  pooled head (w_rec 1, w_fea 1, w_adv 0.1, r1_gamma 10, :330-491);
- `invert`: per-image Adam on z from E's encoding, loss pix·MSE(x, G(z)) +
  reg·MSE(z, E(G(z))) (:544-638), all images in one batch;
- `invert_bn`: z re-expressed as a learnable, per-image weighted mix of
  per-class normalisations against PSO particle populations
  (util_inverter_statistics.py:476-598).

What differs from the JAX package, none of it in the values:
- one step maker serves both encoders. The JAX package threads the AttGAN
  encoder's BN state through separate `*_stateful` steps (:100, :263);
  here the module holds its state and its mode picks the statistics. Each
  train step runs E ONCE in train mode, so an AttGAN encoder's running
  statistics move once per step from the pre-step weights (:286-289), and
  the adversarial step feeds that one forward to both the D step (detached)
  and the E step;
- the optimizers update the modules in place; each step takes the
  gradient of its loss for its own parameters only (`torch.autograd.grad`),
  so the E step leaves nothing in D's `.grad` and G, the feature net and
  (during the E step) D are frozen (`frozen`) while gradients flow through
  them;
- torch cannot replay threefry: every step takes its label-smoothing
  targets as tensors or draws them from a `torch.Generator`, and
  `invert_bn` takes its initial weights `w0` or draws them.

optax and torch apply Adam's bias correction in other orders, so the two
packages agree to rounding, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gan_discovery_pso_tpu_torch.core.config import AdamConfig
from gan_discovery_pso_tpu_torch.train.common import (
    bce_from_logits,
    frozen,
    make_optimizer,
    optimizer_step,
    smooth_negative,
    smooth_positive,
)

# the reference's loss weights and R1 strength (util_inverter.py:330), and
# the inversions' Adam rates and regulariser weight (:544-638;
# util_inverter_statistics.py:476-598)
W_REC, W_FEA, W_ADV, R1_GAMMA = 1.0, 1.0, 0.1, 10.0
INVERT_LR, WEIGHTS_LR, LOSS_REG_WEIGHT = 1e-2, 0.1, 2.0


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def _targets(draw, bs: int, device, negatives: bool = True) -> tuple:
    """(y_real, y_fake) [bs] each: given tensors (y_real alone for
    negatives=False), or smoothed draws from a generator, positives
    first."""
    if isinstance(draw, torch.Generator):
        pos = smooth_positive(draw, (bs,), device)
        return pos, smooth_negative(draw, (bs,), device) if negatives else None
    if torch.is_tensor(draw):
        draw = (draw, None)
    return tuple(None if t is None else t.to(device, torch.float32) for t in draw)


# -- pix_rec: E alone ----------------------------------------------------------


def make_pix_rec_step(gen: nn.Module, encoder: nn.Module, adam: AdamConfig):
    """(train_step, eval_step), each real [N, C, H, W] → MSE(real, G(E(real))),
    the JAX package's `make_pix_rec_step` (:71) and, for an encoder with BN
    state, `make_pix_rec_step_stateful` (:100). train_step runs E in train
    mode (an AttGAN's running statistics take the new state of its one
    forward) and takes one Adam step on E; eval_step runs E in eval mode
    without gradients."""
    params = list(encoder.parameters())
    opt = make_optimizer(adam, params)

    def train_step(real: torch.Tensor) -> torch.Tensor:
        encoder.train()
        with frozen(gen):
            loss = _mse(real, gen(encoder(real)))
            optimizer_step(opt, params, loss)
        return loss.detach()

    @torch.no_grad()
    def eval_step(real: torch.Tensor) -> torch.Tensor:
        encoder.eval()
        return _mse(real, gen(encoder(real)))

    return train_step, eval_step


# -- pix_fea_rec_adv: E and D with R1 ------------------------------------------


def r1_penalty(disc: nn.Module, real: torch.Tensor) -> torch.Tensor:
    """The batch mean of ‖∂ Σ D(x) / ∂x‖² per sample, D's sigmoid output
    (reference R1_reg, util_inverter.py:304-320). The inner gradient keeps
    its graph (`create_graph=True`), so the penalty differentiates in D's
    weights."""
    x = real.detach().requires_grad_(True)
    (grad_x,) = torch.autograd.grad(torch.sigmoid(disc.logits(x)).sum(), x, create_graph=True)
    return torch.mean(torch.sum(grad_x ** 2, dim=(1, 2, 3)))


def make_pix_fea_rec_adv_step(gen: nn.Module, encoder: nn.Module, disc: nn.Module,
                              cnn: nn.Module, adam_e: AdamConfig, adam_d: AdamConfig):
    """(train_step, eval_step) of the adversarial inverter, the JAX
    package's `make_pix_fea_rec_adv_step` (:152) and its stateful form
    (:263). `cnn` is the frozen assessor in eval mode; its `features` give
    the perceptual loss.

    train_step(real, draw) → the seven metrics, 0-d tensors: D first —
    BCE of D(real) against y_real and of D(fake) against y_fake, fake
    detached, plus R1·γ/2 — then E against the UPDATED D: w_rec·MSE(fake,
    real) + w_fea·MSE(features(fake), features(real)) + w_adv·BCE(D(fake),
    y_real), features(real) without gradients. `draw` is (y_real, y_fake)
    or a generator (positives drawn first); the labels are smoothed, as the
    JAX package's default `label_smoothing=True` does.

    eval_step(real, draw) → the four E metrics with E in eval mode and no
    gradients; `draw` is y_real or a generator, and the positives are
    smoothed here too (reference :379-382 smooths before its phase
    branch)."""
    e_params, d_params = list(encoder.parameters()), list(disc.parameters())
    opt_e, opt_d = make_optimizer(adam_e, e_params), make_optimizer(adam_d, d_params)

    def train_step(real: torch.Tensor, draw) -> dict:
        y_real, y_fake = _targets(draw, real.shape[0], real.device)
        encoder.train()
        cnn.eval()
        with frozen(gen, cnn):
            fake = gen(encoder(real))  # the step's one E forward
            fake_const = fake.detach()
            # D step with R1 (reference :383-397)
            loss_d_adv = (bce_from_logits(disc.logits(real), y_real)
                          + bce_from_logits(disc.logits(fake_const), y_fake)) / 2.0
            loss_d_r1 = r1_penalty(disc, real) * (R1_GAMMA * 0.5)
            loss_d = loss_d_adv + loss_d_r1
            optimizer_step(opt_d, d_params, loss_d)
            # E step against the updated D (reference :399-420)
            with torch.no_grad():
                feat_real = cnn.features(real)
            with frozen(disc):
                l_pix = W_REC * _mse(fake, real)
                l_fea = W_FEA * _mse(cnn.features(fake), feat_real)
                l_adv = W_ADV * bce_from_logits(disc.logits(fake), y_real)
                loss_e = l_pix + l_fea + l_adv
                optimizer_step(opt_e, e_params, loss_e)
        return {k: v.detach() for k, v in (
            ("loss_disc", loss_d), ("loss_disc_adv", loss_d_adv),
            ("loss_disc_r1penalty", loss_d_r1), ("loss_enc", loss_e),
            ("loss_enc_rec_pix", l_pix), ("loss_enc_rec_fea", l_fea),
            ("loss_enc_adv", l_adv))}

    @torch.no_grad()
    def eval_step(real: torch.Tensor, draw) -> dict:
        y_real, _ = _targets(draw, real.shape[0], real.device, negatives=False)
        encoder.eval()
        cnn.eval()
        fake = gen(encoder(real))
        l_pix = W_REC * _mse(fake, real)
        l_fea = W_FEA * _mse(cnn.features(fake), cnn.features(real))
        l_adv = W_ADV * bce_from_logits(disc.logits(fake), y_real)
        return {"loss_enc_rec_pix": l_pix, "loss_enc_rec_fea": l_fea,
                "loss_enc_adv": l_adv, "loss_enc": l_pix + l_fea + l_adv}

    return train_step, eval_step


# -- gradient-descent inversion -------------------------------------------------


def invert(x: torch.Tensor, gen: nn.Module, encoder: nn.Module, iterations: int = 500,
           record_z: bool = False):
    """Latent optimisation of every image of x [B, C, H, W] in [−1, 1] at
    once, from z0 = E(x): `iterations + 1` Adam steps of lr INVERT_LR
    (:438), each on Σ_i MSE_i(x, G(z)) + LOSS_REG_WEIGHT·Σ_i MSE_i(z,
    E(G(z))).

    The loss SUMS the per-image means, so each image's gradient is its B = 1
    gradient and a batched run follows the reference's one-image runs (a
    batch mean would scale the gradients by 1/B, which Adam's eps does not
    cancel). G and E are frozen; the gradient reaches z through both.

    Returns (z [B, z, 1, 1], history {loss, loss_pix, loss_reg}: [iters + 1]
    numpy arrays, each row the per-image means before that step's update;
    with record_z also z [iters + 1, B, z, 1, 1], the latents after each
    update)."""
    n_img = x.shape[0]
    rows, zs = [], []
    with frozen(gen, encoder):
        with torch.no_grad():
            z = encoder(x).clone()
        z.requires_grad_(True)
        opt = torch.optim.Adam([z], lr=INVERT_LR)
        for _ in range(iterations + 1):
            x_rec = gen(z)
            loss_pix = torch.sum(torch.mean((x - x_rec) ** 2, dim=(1, 2, 3)))
            loss_reg = torch.sum(torch.mean((z - encoder(x_rec)) ** 2, dim=(1, 2, 3)))
            loss = loss_pix + loss_reg * LOSS_REG_WEIGHT
            optimizer_step(opt, [z], loss)
            rows.append(torch.stack([loss, loss_pix, loss_reg]).detach() / n_img)
            if record_z:
                zs.append(z.detach().clone())
    hist = torch.stack(rows).cpu().numpy()
    out = {"loss": hist[:, 0], "loss_pix": hist[:, 1], "loss_reg": hist[:, 2]}
    if record_z:
        out["z"] = torch.stack(zs).cpu().numpy()
    return z.detach(), out


def invert_bn(x: torch.Tensor, gen: nn.Module, encoder: nn.Module, class_particles,
              iterations: int = 500, generator: torch.Generator | None = None, w0=None):
    """Statistics-regularised inversion (util_inverter_statistics.py:
    476-598): z is re-expressed as Σ_c w_c·BN(z; μ_c, σ_c) / Σ_c w_c, with
    (μ_c, σ_c) the per-dimension statistics of class c's PSO particles
    (class_particles [C, N, d]) and w learnable: one weight vector per
    image, N(0, 1) at the start (`w0` [B, C], else drawn on the CPU from
    `generator`, or from one seeded 0 when None).
    One Adam with two parameter groups: z at INVERT_LR, w at WEIGHTS_LR
    (optax's `multi_transform`). `iterations + 1` steps; the
    loss sums the per-image pixel means, so images stay independent.

    Returns (z [B, d, 1, 1], the mix of the final pass before its update;
    w [B, C], the weights of that pass; history {loss, loss_pix}: [iters +
    1] numpy arrays, before each update)."""
    device = x.device
    rows = []
    with frozen(gen, encoder):
        with torch.no_grad():
            z = encoder(x).clone()
        parts = torch.tensor(np.array(class_particles), dtype=torch.float32, device=device)
        if parts.shape[-1] != z.shape[1]:
            raise ValueError(
                f"PSO particles have dim_space={parts.shape[-1]} but the encoder produces "
                f"z_dim={z.shape[1]} latents — the --path-pso run must come from a "
                "discovery sweep at this GAN's latent dimension")
        n_img, n_classes = x.shape[0], parts.shape[0]
        if w0 is None:
            g = generator if generator is not None else torch.Generator().manual_seed(0)
            w0 = torch.randn((n_img, n_classes), generator=g)
        if not torch.is_tensor(w0):
            w0 = torch.tensor(np.array(w0), dtype=torch.float32)
        w = w0.to(device, torch.float32).clone().requires_grad_(True)
        mu = parts.mean(dim=1)  # [C, d]
        var = torch.mean((parts - mu[:, None, :]) ** 2, dim=1)
        mu, sd = mu[:, None, :, None, None], torch.sqrt(var[:, None, :, None, None] + 1e-5)
        z.requires_grad_(True)
        opt = torch.optim.Adam([{"params": [z], "lr": INVERT_LR},
                                {"params": [w], "lr": WEIGHTS_LR}])
        for _ in range(iterations + 1):
            zn = (z[None] - mu) / sd  # [C, B, d, 1, 1]
            z_mix = torch.einsum("bc,cbdhw->bdhw", w, zn) / torch.sum(w, dim=1)[:, None, None, None]
            pix_i = torch.mean((x - gen(z_mix)) ** 2, dim=(1, 2, 3))
            loss = torch.sum(pix_i)
            z_final, w_final = z_mix.detach(), w.detach().clone()
            optimizer_step(opt, [z, w], loss)
            rows.append(torch.stack([loss / n_img, torch.mean(pix_i)]).detach())
    hist = torch.stack(rows).cpu().numpy()
    return z_final, w_final, {"loss": hist[:, 0], "loss_pix": hist[:, 1]}
