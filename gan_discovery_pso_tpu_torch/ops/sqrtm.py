"""Matrix square roots on the device for the FID (counterpart of
`gan_discovery_pso_tpu/ops/sqrtm.py`).

The reference takes FID's trace term from `scipy.linalg.sqrtm` on the host
(reference src/evaluation/util_gan_evaluation.py:19-41). As in the JAX
package, the symmetric-product identity keeps it on the device:

    tr(sqrtm(Σx · Σy)) = tr(sqrtm(Σx^½ · Σy · Σx^½)) = Σ_i sqrt(λ_i)

with Σx^½ from `torch.linalg.eigh` of the symmetric PSD Σx, in fp32, its
products in full fp32 under `--fast-math` too (`highest_precision`, the
JAX package's explicit HIGHEST): TF32 there would bias the trace term.
"""

from __future__ import annotations

import torch

from gan_discovery_pso_tpu_torch.ops.precision import highest_precision


def sqrtm_psd(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """The principal square root of a symmetric PSD matrix, by eigh."""
    a = 0.5 * (a + a.T)  # symmetric against rounding
    w, v = torch.linalg.eigh(a)
    w = torch.sqrt(torch.clamp(w, min=eps))
    with highest_precision():
        return torch.matmul(v * w[None, :], v.T)


def trace_sqrt_product(sigma_x: torch.Tensor, sigma_y: torch.Tensor) -> torch.Tensor:
    """tr(sqrtm(Σx · Σy)) of symmetric PSD Σx and Σy, the FID cross term."""
    half = sqrtm_psd(sigma_x)
    with highest_precision():
        m = torch.matmul(torch.matmul(half, sigma_y), half)
    m = 0.5 * (m + m.T)
    return torch.sum(torch.sqrt(torch.clamp(torch.linalg.eigvalsh(m), min=0.0)))
