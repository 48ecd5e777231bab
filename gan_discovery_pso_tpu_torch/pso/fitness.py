"""Discovery and hybrid-inversion fitness: particle positions → objective,
batched over every particle of every swarm (counterpart of
`gan_discovery_pso_tpu/pso/fitness.py:35-96,132-196`).

Reference src/pso/util_discovery.py:33-82:
- positions [M, d] reshape to latents [M, d, 1, 1];
- generator forward (eval), per-sample min-max rescale to [0, 1];
- assessor softmax posterior: multi-class nets take the class column (here
  per row, so one batch holds every class's swarm), binary nets column 1;
- 'optimize_in_training'  → min(p + thr, 1) + eps,
  'optimize_out_training' → 1 − min(p + thr, 1) + eps.

The pso-inverter's hybrid fitness (reference util_discovery.py:84-101)
adds w_rec · MSE(source slice, RAW generator output in [−1, 1]) to w_ass ·
the assessor term, then eps a second time: values lie in
[2·eps, 1 + 2·eps + 4·w_rec] for w_ass = 1.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch import nn

from gan_discovery_pso_tpu_torch.core.profiling import span
from gan_discovery_pso_tpu_torch.ops.kernels import rescale01_per_sample
from gan_discovery_pso_tpu_torch.ops.precision import cast_model, fp32_parity

OPTIMIZE_IN = "optimize_in_training"
OPTIMIZE_OUT = "optimize_out_training"


def assessor_posterior(logits: torch.Tensor, class_idx) -> torch.Tensor:
    """Softmax over classes, then the target column: `class_idx` is an int
    or a [M] tensor with one class per row; binary nets take column 1."""
    probs = torch.softmax(logits.float(), dim=1)
    if logits.shape[1] <= 2:
        return probs[:, 1]
    idx = torch.as_tensor(class_idx, dtype=torch.long, device=probs.device)
    idx = idx.expand(probs.shape[0]) if idx.dim() == 0 else idx
    return probs.gather(1, idx[:, None]).squeeze(1)


def fitness_from_posterior(p: torch.Tensor, control: str, threshold: float = 0.0,
                           eps: float = 0.1) -> torch.Tensor:
    clipped = torch.clamp(p + threshold, max=1.0)
    if control == OPTIMIZE_IN:
        return clipped + eps
    if control == OPTIMIZE_OUT:
        return (1.0 - clipped) + eps
    raise ValueError(control)


def apply_discovery_fitness(
    positions: torch.Tensor,
    gen_model: nn.Module,
    assessor: nn.Module,
    class_idx,
    control: str = OPTIMIZE_OUT,
    threshold: float = 0.0,
    eps: float = 0.1,
    dtype: torch.dtype | None = None,
    return_images: bool = False,
    rescale: Callable = rescale01_per_sample,
):
    """positions [M, d] → fitness [M] (fp32). `dtype` (bf16 mode) casts the
    latents; the caller casts the models (`ops.precision.cast_model`). The
    images come out fp32 either way (`ops/conv.py`); in bf16 mode the rescale
    kernel casts them to bf16, the cast the assessor's first conv would make
    (the JAX package casts there). `return_images` gives
    (fitness, (rescaled images, generator images)), each [M, C, H, W].
    `rescale` is B2's wrapper; an exported program passes the registered
    operator (`ops.kernels.rescale01_per_sample_op`). Spans: fitness.generator,
    fitness.rescale, fitness.assessor, fitness.objective."""
    with span("fitness.generator"):
        z = positions.reshape(positions.shape[0], positions.shape[1], 1, 1)
        if dtype is not None:
            z = z.to(dtype)
        img = gen_model(z)
    with span("fitness.rescale"):
        img01 = rescale(img.float(), out_dtype=dtype or img.dtype)
    with span("fitness.assessor", device_time=True):
        logits = assessor(img01)
    with span("fitness.objective"):
        vals = fitness_from_posterior(assessor_posterior(logits, class_idx),
                                      control, threshold, eps)
    if return_images:
        return vals, (img01, img)
    return vals


def make_discovery_fitness_dynamic(
    gen_model: nn.Module,
    assessor: nn.Module,
    control: str = OPTIMIZE_OUT,
    threshold: float = 0.0,
    eps: float = 0.1,
    dtype: torch.dtype | None = None,
) -> Callable:
    """Discovery fitness with the class index as an argument:
    fitness(positions [M, d], class_idx, return_images=False) → [M] on the
    models' device. positions may be a numpy array. fp32 runs under
    `fp32_parity`; dtype=torch.bfloat16 casts copies of the models once."""
    gen, cnn = cast_model(gen_model, dtype), cast_model(assessor, dtype)
    device = next(gen.parameters()).device

    def fitness(positions, class_idx, return_images: bool = False):
        pos = torch.as_tensor(positions, dtype=torch.float32, device=device)
        precision = fp32_parity() if dtype is None else contextlib.nullcontext()
        with precision, torch.inference_mode():
            return apply_discovery_fitness(pos, gen, cnn, class_idx, control=control,
                                           threshold=threshold, eps=eps, dtype=dtype,
                                           return_images=return_images)

    return fitness


def inverter_fitness(
    positions: torch.Tensor,
    gen_model: nn.Module,
    assessor: nn.Module,
    source_images: torch.Tensor,
    class_idx,
    control: str = OPTIMIZE_IN,
    threshold: float = 0.0,
    eps: float = 0.1,
    w_ass: float = 1.0,
    w_rec: float = 1.0,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """positions [M, d] → hybrid fitness [M]; particle i owns source image
    i of source_images [M, C, H, W] in [−1, 1] (the encoder-seeded init).
    Span: fitness.reconstruction, the pixel term and the sum."""
    vals, (_img01, img) = apply_discovery_fitness(
        positions, gen_model, assessor, class_idx, control=control, threshold=threshold,
        eps=eps, dtype=dtype, return_images=True)
    with span("fitness.reconstruction"):
        # against the raw G output, not the rescaled image (util_discovery.py:96-98)
        f_rec = w_rec * torch.mean((source_images.float() - img.float()) ** 2, dim=(1, 2, 3))
        # the reference adds eps a second time on the combined value (:101)
        return w_ass * vals + f_rec + eps


def make_inverter_fitness(
    gen_model: nn.Module,
    assessor: nn.Module,
    source_images,
    class_idx: int,
    control: str = OPTIMIZE_IN,
    threshold: float = 0.0,
    eps: float = 0.1,
    w_ass: float = 1.0,
    w_rec: float = 1.0,
) -> Callable:
    """The hybrid fitness as fitness(positions [M, d]) → [M] on the models'
    device, in fp32 parity (JAX `:132`). positions and source_images may be
    numpy arrays."""
    device = next(gen_model.parameters()).device
    src = torch.as_tensor(source_images, dtype=torch.float32, device=device)

    def fitness(positions):
        pos = torch.as_tensor(positions, dtype=torch.float32, device=device)
        with fp32_parity(), torch.inference_mode():
            return inverter_fitness(pos, gen_model, assessor, src, class_idx, control=control,
                                    threshold=threshold, eps=eps, w_ass=w_ass, w_rec=w_rec)

    return fitness
