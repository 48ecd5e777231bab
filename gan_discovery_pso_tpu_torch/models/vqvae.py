"""VQ-VAE with a PSO-initialised codebook and a frozen-DCGAN decoder
(counterpart of `gan_discovery_pso_tpu/models/vqvae.py`: `vq_indices` :50,
`vq_straight_through` :66, `codebook_init` :84, `codebook_from_pso` :90,
`VQVAEGanDef` and the `vqvae_dcgan` variant :100-210 with
`load_frozen_decoder` :149, the `vqvae` and `vqvae_mnist` variants
:213-362, `get_vqvae` :365, `vq_loss_terms` :377).

Reference src/inverter/utils_vq_vae/util_model.py:125-322 and the custom
autograd pair of src/hands_on/vq_vae/utils/util_function.py:4-66:

- the nearest code is the argmin of the expanded-form distance
  ‖z‖² − 2·z·cᵀ + ‖c‖² (one matmul, in full fp32 under `--fast-math` too,
  as the JAX package pins it at HIGHEST), the first index on exact ties
  (`torch.argmin`);
- the straight-through estimator is z_e + (z_q − z_e).detach();
- the codebook's gradient is the segment sum over the selected rows, the
  backward of `F.embedding` (the reference's `index_add_`); on the card that
  backward sorts the indices and sums each segment in order, so two runs
  give the same bits (`codebook[idx]`'s backward accumulates with atomics,
  in an order that varies).

Variants (reference get_model, util_model.py:23-31):
- `vqvae_dcgan` (`VQVAEGan`): the encoder is the discriminator's shape with
  a BN in its middle block, the decoder the DCGAN generator, which the
  pipeline replaces by a trained, frozen G (`load_frozen_decoder`): its
  parameters take no gradient and its BN stays in eval mode
  (util_training.py:14-16), whatever the module's mode;
- `vqvae` (`VQVAE`): conv stack and two BN res-blocks on each side, a 7x7
  latent grid for 28x28 inputs;
- `vqvae_mnist` (`VQVAEMnist`): three convs down to 1x1, three transposed
  convs up.

Parameter names are the JAX trees' keys (`encoder.conv1`, `codebook`,
`enc_res1.bn2`, ...); the vqvae_dcgan decoder carries the Generator's
(`decoder.gen.0.0`). The seeded init draws from the `torch.Generator` the
caller passes: xavier-uniform conv weights, zero conv biases, identity BN
(weights_init, util_model.py:39-46), the codebook U(−1/K, 1/K)
(util_model.py:132) or the PSO particles.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from gan_discovery_pso_tpu_torch.models.dcgan import Generator, GeneratorDef
from gan_discovery_pso_tpu_torch.ops import (
    batch_norm_eval,
    batch_norm_train,
    conv2d,
    conv_transpose2d,
)
from gan_discovery_pso_tpu_torch.ops.precision import highest_precision

_CONVS = (nn.Conv2d, nn.ConvTranspose2d)


# -- vector quantisation -------------------------------------------------------


def vq_indices(z_e_nhwc: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """z_e [..., D], codebook [K, D] → the nearest code's index [...]."""
    flat = z_e_nhwc.reshape(-1, codebook.shape[1])
    with highest_precision():
        d = (torch.sum(flat * flat, dim=1, keepdim=True) - 2.0 * (flat @ codebook.T)
             + torch.sum(codebook * codebook, dim=1)[None, :])
    return torch.argmin(d, dim=1).reshape(z_e_nhwc.shape[:-1])


def vq_straight_through(z_e: torch.Tensor, codebook: torch.Tensor) -> tuple:
    """(z_q_st, z_q_bar, indices) for NCHW z_e. z_q_st feeds the decoder and
    passes its gradient to z_e unchanged; z_q_bar is the codebook rows the
    vq loss differentiates (segment-summed into the codebook)."""
    z_e_nhwc = z_e.permute(0, 2, 3, 1)
    idx = vq_indices(z_e_nhwc.detach(), codebook.detach())
    codes = F.embedding(idx, codebook.detach())
    z_q_st = z_e_nhwc + (codes - z_e_nhwc).detach()
    z_q_bar = F.embedding(idx, codebook)
    return z_q_st.permute(0, 3, 1, 2), z_q_bar.permute(0, 3, 1, 2), idx


def codebook_init(generator: torch.Generator, num_embedding: int,
                  embedded_dim: int) -> torch.Tensor:
    """U(−1/K, 1/K) [K, D] (reference util_model.py:132)."""
    k = num_embedding
    return torch.empty(k, embedded_dim).uniform_(-1.0 / k, 1.0 / k, generator=generator)


def codebook_from_pso(particle_positions) -> torch.Tensor:
    """The final PSO particle positions [K, D] as the codebook (reference
    pso_weights, util_model.py:49-54; src/training/vq_vae.py:30-57)."""
    return torch.as_tensor(particle_positions, dtype=torch.float32).clone()


def vq_loss_terms(x, x_tilde, z_e, z_q_bar, beta: float = 0.25) -> tuple:
    """(recons, vq, β·commit); the loss is their sum (reference
    src/inverter/utils_vq_vae/util_training.py:26-34)."""
    loss_recons = torch.mean((x_tilde - x) ** 2)
    loss_vq = torch.mean((z_q_bar - z_e.detach()) ** 2)
    loss_commit = torch.mean((z_e - z_q_bar.detach()) ** 2)
    return loss_recons, loss_vq, beta * loss_commit


# -- layers ----------------------------------------------------------------------


def _conv(x, m: nn.Module, stride: int, padding: int) -> torch.Tensor:
    return conv2d(x, m.weight, m.bias, stride, padding)


def _convt(x, m: nn.Module, stride: int, padding: int) -> torch.Tensor:
    return conv_transpose2d(x, m.weight, m.bias, stride, padding)


def _bn(x, bn: nn.BatchNorm2d, train: bool) -> torch.Tensor:
    if train:
        return batch_norm_train(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                bn.momentum, bn.eps)
    return batch_norm_eval(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)


@torch.no_grad()
def _init_(model: nn.Module, generator: torch.Generator) -> None:
    """xavier-uniform conv weights and zero conv biases, identity BN, in
    place (weights_init, util_model.py:39-46)."""
    for m in model.modules():
        if isinstance(m, _CONVS):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.reset_running_stats()


def _codebook(generator, d, data_pso) -> nn.Parameter:
    return nn.Parameter(codebook_from_pso(data_pso) if data_pso is not None
                        else codebook_init(generator, d.num_embedding, d.embedded_dim))


# -- vqvae_dcgan: the variant the pipeline trains ---------------------------------


class VQVAEGanDef(NamedTuple):
    channels_img: int = 1
    embedded_dim: int = 100
    num_embedding: int = 256
    features_g: int = 64
    features_d: int = 64


class _GanEncoder(nn.Module):
    def __init__(self, d: VQVAEGanDef):
        super().__init__()
        f = d.features_d
        self.conv1 = nn.Conv2d(d.channels_img, f, 4, 2, 1)
        self.conv2 = nn.Conv2d(f, f * 2, 4, 2, 1)
        self.bn2 = nn.BatchNorm2d(f * 2)
        self.conv3 = nn.Conv2d(f * 2, d.embedded_dim, 7, 2, 0)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        h = F.leaky_relu(_conv(x, self.conv1, 2, 1), 0.2)
        h = F.leaky_relu(_bn(_conv(h, self.conv2, 2, 1), self.bn2, train), 0.2)
        return _conv(h, self.conv3, 2, 0)


class VQVAEGan(nn.Module):
    """x [N, C, 28, 28] → (x̃, z_e, z_q_bar, indices), the reference's
    (x̃, z_e_x, z_q_x) (util_model.py:318-322); the latent grid is 1x1."""

    def __init__(self, d: VQVAEGanDef, generator: torch.Generator | None = None,
                 data_pso=None):
        super().__init__()
        self.d = d
        self.encoder = _GanEncoder(d)
        self.codebook = _codebook(generator, d, data_pso)
        self.decoder = Generator(GeneratorDef(d.embedded_dim, d.channels_img, d.features_g))
        self.frozen_decoder = False
        if generator is not None:
            _init_(self.encoder, generator)
            _init_(self.decoder, generator)

    def train(self, mode: bool = True) -> "VQVAEGan":
        super().train(mode)
        if self.frozen_decoder:
            self.decoder.eval()
        return self

    def forward(self, x: torch.Tensor) -> tuple:
        z_e = self.encoder(x, self.training)
        z_q_st, z_q_bar, idx = vq_straight_through(z_e, self.codebook)
        return self.decoder(z_q_st), z_e, z_q_bar, idx

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Images → code indices [N, 1, 1], BN by the running statistics
        (reference `encode`, util_model.py:308-311)."""
        z_e = self.encoder(x, False)
        return vq_indices(z_e.permute(0, 2, 3, 1), self.codebook)

    def decode(self, idx: torch.Tensor) -> torch.Tensor:
        """Code indices [N, H, W] → images, the decoder in eval mode
        (reference `decode`, util_model.py:313-316)."""
        mode = self.decoder.training
        self.decoder.eval()
        try:
            return self.decoder(F.embedding(idx, self.codebook).permute(0, 3, 1, 2))
        finally:
            self.decoder.train(mode)


def load_frozen_decoder(model: VQVAEGan, gen: nn.Module) -> VQVAEGan:
    """Copy the trained generator `gen` into the decoder and freeze it: no
    gradient, BN in eval mode (reference src/training/vq_vae.py:189-195)."""
    model.decoder.load_state_dict(gen.state_dict(), strict=True)
    model.decoder.requires_grad_(False)
    model.frozen_decoder = True
    return model.train(model.training)


# -- vqvae and vqvae_mnist: the reference's other two variants --------------------


class VQVAEDef(NamedTuple):
    channels_img: int = 1
    embedded_dim: int = 64
    num_embedding: int = 512


class _ResBlockBN(nn.Module):
    """ReLU → Conv3 → BN → ReLU → Conv1 → BN, plus the input
    (ResBlockBatchNorm, util_model.py:151-164)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, 1, 1)
        self.bn1 = nn.BatchNorm2d(dim)
        self.conv2 = nn.Conv2d(dim, dim, 1, 1, 0)
        self.bn2 = nn.BatchNorm2d(dim)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        h = _bn(_conv(torch.relu(x), self.conv1, 1, 1), self.bn1, train)
        return x + _bn(_conv(torch.relu(h), self.conv2, 1, 0), self.bn2, train)


class VQVAE(nn.Module):
    """`vqvae` (util_model.py:179-222): Conv4s2 + BN + ReLU, Conv4s2, two
    res-blocks → VQ → two res-blocks, ReLU, ConvT4s2 + BN + ReLU, ConvT4s2 +
    Tanh."""

    def __init__(self, d: VQVAEDef, generator: torch.Generator | None = None, data_pso=None):
        super().__init__()
        dim = d.embedded_dim
        self.enc_conv1 = nn.Conv2d(d.channels_img, dim, 4, 2, 1)
        self.enc_bn1 = nn.BatchNorm2d(dim)
        self.enc_conv2 = nn.Conv2d(dim, dim, 4, 2, 1)
        self.enc_res1, self.enc_res2 = _ResBlockBN(dim), _ResBlockBN(dim)
        self.codebook = _codebook(generator, d, data_pso)
        self.dec_res1, self.dec_res2 = _ResBlockBN(dim), _ResBlockBN(dim)
        self.dec_convt1 = nn.ConvTranspose2d(dim, dim, 4, 2, 1)
        self.dec_bn1 = nn.BatchNorm2d(dim)
        self.dec_convt2 = nn.ConvTranspose2d(dim, d.channels_img, 4, 2, 1)
        if generator is not None:
            _init_(self, generator)

    def forward(self, x: torch.Tensor) -> tuple:
        t = self.training
        h = torch.relu(_bn(_conv(x, self.enc_conv1, 2, 1), self.enc_bn1, t))
        h = self.enc_res1(_conv(h, self.enc_conv2, 2, 1), t)
        z_e = self.enc_res2(h, t)
        z_q_st, z_q_bar, idx = vq_straight_through(z_e, self.codebook)
        h = torch.relu(self.dec_res2(self.dec_res1(z_q_st, t), t))
        h = torch.relu(_bn(_convt(h, self.dec_convt1, 2, 1), self.dec_bn1, t))
        return torch.tanh(_convt(h, self.dec_convt2, 2, 1)), z_e, z_q_bar, idx


class VQVAEMnistDef(NamedTuple):
    channels_img: int = 1
    embedded_dim: int = 64
    num_embedding: int = 512
    num_hiddens: int = 64


class VQVAEMnist(nn.Module):
    """`vqvae_mnist` (util_model.py:224-264): three convs to a 1x1 latent,
    three transposed convs back."""

    def __init__(self, d: VQVAEMnistDef, generator: torch.Generator | None = None,
                 data_pso=None):
        super().__init__()
        nh = d.num_hiddens
        self.enc_conv1 = nn.Conv2d(d.channels_img, nh // 2, 4, 2, 1)
        self.enc_conv2 = nn.Conv2d(nh // 2, nh, 4, 2, 1)
        self.enc_conv3 = nn.Conv2d(nh, d.embedded_dim, 7, 2, 0)
        self.codebook = _codebook(generator, d, data_pso)
        self.dec_convt1 = nn.ConvTranspose2d(d.embedded_dim, nh, 7, 2, 0)
        self.dec_convt2 = nn.ConvTranspose2d(nh, nh // 2, 4, 2, 1)
        self.dec_convt3 = nn.ConvTranspose2d(nh // 2, d.channels_img, 4, 2, 1)
        if generator is not None:
            _init_(self, generator)

    def forward(self, x: torch.Tensor) -> tuple:
        h = torch.relu(_conv(x, self.enc_conv1, 2, 1))
        h = torch.relu(_conv(h, self.enc_conv2, 2, 1))
        z_e = _conv(h, self.enc_conv3, 2, 0)
        z_q_st, z_q_bar, idx = vq_straight_through(z_e, self.codebook)
        h = torch.relu(_convt(z_q_st, self.dec_convt1, 2, 0))
        h = torch.relu(_convt(h, self.dec_convt2, 2, 1))
        return torch.tanh(_convt(h, self.dec_convt3, 2, 1)), z_e, z_q_bar, idx


def get_vqvae(name: str) -> tuple:
    """(Def class, module class) of a variant (reference get_model,
    util_model.py:23-31)."""
    variants = {"vqvae": (VQVAEDef, VQVAE), "vqvae_mnist": (VQVAEMnistDef, VQVAEMnist),
                "vqvae_dcgan": (VQVAEGanDef, VQVAEGan)}
    if name not in variants:
        raise ValueError(name)
    return variants[name]
