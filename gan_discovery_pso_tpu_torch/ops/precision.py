"""Precision policy: fp32 parity, or bf16 model forwards.

Counterpart of `gan_discovery_pso_tpu/ops/precision.py`. The JAX package
runs every conv and matmul at `Precision.HIGHEST` unless `fast_math()` is on.
PyTorch's own default on the card runs fp32 convolutions in TF32 (cuDNN),
which keeps about three decimal digits, so the parity mode turns TF32 off
for convolutions and matmuls. It also pins cuDNN to deterministic algorithm
choices, so that two fp32 runs with the same seed give identical results.

The bf16 mode is not a global switch: the runner casts copies of the models
to bf16 once per call (`cast_model`), and the swarm math stays fp32.
"""

from __future__ import annotations

import contextlib
import copy

import torch


def cast_model(model: torch.nn.Module, dtype: torch.dtype | None) -> torch.nn.Module:
    """The model itself when dtype is None, else a copy whose parameters and
    buffers (BN running stats included) are cast to dtype — the JAX
    package's `jax.tree.map(lambda x: x.astype(dtype), params)`."""
    if dtype is None:
        return model
    return copy.deepcopy(model).to(dtype)


@contextlib.contextmanager
def fp32_parity():
    """Full-fp32 convs and matmuls, deterministic cuDNN algorithms; the
    previous settings come back on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
             cudnn.benchmark)
    cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    cudnn.deterministic = True
    cudnn.benchmark = False
    try:
        yield
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = saved
