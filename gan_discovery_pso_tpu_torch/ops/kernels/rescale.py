"""Fused per-row min-max rescale: CUDA kernel `csrc/rescale.cu` and its plain
PyTorch version.

Counterpart of `gan_discovery_pso_tpu/ops/pallas/rescale.py`
(`rescale01_rows`, `rescale01_per_sample_pallas`). The wrapper takes the
plain version for CPU tensors only; for CUDA tensors it launches the kernel
or raises. `rescale01_rows.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from gan_discovery_pso_tpu_torch.ops.kernels import _build
from gan_discovery_pso_tpu_torch.ops.rescale import rescale01_per_sample as _plain

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def rescale01_rows_plain(x: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """[N, F] → per-row (x − min) / (max − min), clamped to [0, 1], computed
    in fp32 and cast to out_dtype (default: x's dtype)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    return _plain(x.float()).to(out_dtype)


def rescale01_rows(x: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Per-row min-max rescale of [N, F] fp32 to [0, 1], cast in the kernel
    to out_dtype (fp32 or bf16; default x's dtype)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return rescale01_rows_plain(x, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"rescale01_rows: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("rescale01_rows: x must be a contiguous 2-D fp32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"rescale01_rows: out_dtype must be fp32 or bf16, got {out_dtype}")
    n, f = x.shape
    out = torch.empty((n, f), dtype=out_dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gdpt_rescale01_rows(x.data_ptr(), out.data_ptr(), n, f,
                                      int(out_dtype == torch.bfloat16), stream)
    _build.check(err, "rescale01_rows")
    rescale01_rows.launches += 1
    return out


rescale01_rows.launches = 0


def rescale01_per_sample(imgs: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """`ops.rescale.rescale01_per_sample` on [N, C, H, W] through the fused
    rows kernel (flattened per sample), with the cast folded in."""
    n = imgs.shape[0]
    return rescale01_rows(imgs.reshape(n, -1), out_dtype).reshape(imgs.shape)
