"""Fused per-row min-max rescale: CUDA kernel `csrc/rescale.cu` and its plain
PyTorch version.

Counterpart of `gan_discovery_pso_tpu/ops/pallas/rescale.py`
(`rescale01_rows`, `rescale01_per_sample_pallas`). The wrapper takes the
plain version for CPU tensors only; for CUDA tensors it launches the kernel
or raises. `rescale01_rows.launches` counts kernel launches.
`rescale_geometry` and `rescale_vector` are the pure-Python choices of the
launch: warps per row and rows per CTA for rows held in registers, and the
float4 or scalar walk. The kernel itself takes rows longer than it holds in
registers (`csrc/rescale.cu:kShortMaxF`, 4096 floats) a CTA each.
"""

from __future__ import annotations

import torch

from gan_discovery_pso_tpu_torch.ops.kernels import _build
from gan_discovery_pso_tpu_torch.ops.rescale import rescale01_per_sample as _plain

_OUT_DTYPES = (torch.float32, torch.bfloat16)
MAX_WARPS_PER_CTA = 8
TARGET_WARPS = 4096  # warps in flight over the card: about 31 per SM


def rescale_geometry(n: int) -> tuple[int, int]:
    """(team, rows per CTA) for n rows held in registers.

    A team is the warps that hold one row: the most (a power of two up to
    8) that keep n * team within TARGET_WARPS. A team of several warps is a
    CTA ([256, .]: 8, [1024, .]: 4); a team of one (n > 2048) shares its
    CTA with 7 other rows ([4096, .]: 512 CTAs). The kernel launches
    ceil(n / rows per CTA) CTAs."""
    team = MAX_WARPS_PER_CTA
    while team > 1 and n * team > TARGET_WARPS:
        team //= 2
    return (team, 1) if team > 1 else (1, MAX_WARPS_PER_CTA)


def rescale_vector(x_ptr: int, out_ptr: int, out_itemsize: int) -> bool:
    """float4 loads (with a scalar head and tail per row) when x is 16-byte
    aligned and out is aligned to 4 of its elements, so every row's input
    and output share their head; otherwise (an offset view) a scalar walk."""
    return x_ptr % 16 == 0 and out_ptr % (4 * out_itemsize) == 0


def rescale01_rows_plain(x: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """[N, F] → per-row (x − min) / (max − min), clamped to [0, 1], computed
    in fp32 and cast to out_dtype (default: x's dtype)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    return _plain(x.float()).to(out_dtype)


def rescale01_rows(x: torch.Tensor, out_dtype: torch.dtype | None = None, *,
                   geometry: tuple[int, int] | None = None) -> torch.Tensor:
    """Per-row min-max rescale of [N, F] fp32 to [0, 1], cast in the kernel
    to out_dtype (fp32 or bf16; default x's dtype). `geometry` (team, rows
    per CTA) overrides `rescale_geometry` (a launch-geometry sweep); the CPU
    ignores it."""
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
    out = x.new_empty((n, f), dtype=out_dtype)
    team, rows = rescale_geometry(n) if geometry is None else geometry
    x_ptr, out_ptr = x.data_ptr(), out.data_ptr()
    err = _build.call(_build.library().gdpt_rescale01_rows, x.device, x_ptr, out_ptr, n, f,
                      out_dtype == torch.bfloat16, team, rows,
                      rescale_vector(x_ptr, out_ptr, out.element_size()))
    _build.check(err, "rescale01_rows")
    rescale01_rows.launches += 1
    return out


rescale01_rows.launches = 0


def rescale01_per_sample(imgs: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """`ops.rescale.rescale01_per_sample` on [N, C, H, W] through the fused
    rows kernel (flattened per sample), with the cast folded in."""
    n = imgs.shape[0]
    return rescale01_rows(imgs.reshape(n, -1), out_dtype).reshape(imgs.shape)
