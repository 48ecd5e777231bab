"""The Fréchet distance on CAE embeddings, on the device (counterpart of
`gan_discovery_pso_tpu/evaluation/fid.py`; reference
src/evaluation/util_gan_evaluation.py:16-52). Products in full fp32, under
`--fast-math` too (`highest_precision`, the JAX package's explicit HIGHEST);
the matrix square root is `ops/sqrtm.py`'s."""

from __future__ import annotations

import torch

from gan_discovery_pso_tpu_torch.ops.precision import highest_precision
from gan_discovery_pso_tpu_torch.ops.sqrtm import trace_sqrt_product


def mean_and_cov(features: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The column mean and unbiased covariance of [N, D] features
    (np.cov with rowvar=False)."""
    mu = torch.mean(features, dim=0)
    centered = features - mu[None, :]
    with highest_precision():
        cov = torch.matmul(centered.T, centered) / (features.shape[0] - 1)
    return mu, cov


def frechet_distance(mu_x, mu_y, sigma_x, sigma_y) -> torch.Tensor:
    """‖μx − μy‖² + tr(Σx + Σy − 2·sqrtm(Σx·Σy))."""
    diff = mu_x - mu_y
    return (torch.sum(diff * diff) + torch.trace(sigma_x) + torch.trace(sigma_y)
            - 2.0 * trace_sqrt_product(sigma_x, sigma_y))


def fid_from_features(real_features: torch.Tensor, synthetic_features: torch.Tensor
                      ) -> torch.Tensor:
    """Embeddings in, FID out (a 0-d tensor)."""
    mu_r, cov_r = mean_and_cov(real_features)
    mu_s, cov_s = mean_and_cov(synthetic_features)
    return frechet_distance(mu_r, mu_s, cov_r, cov_s)
