"""Geometric augmentation of CT slices, batched on the device (counterpart
of `gan_discovery_pso_tpu/data/augment.py`: `AugmentConfig` :21,
`_bilinear_sample` :32, `_affine_grid` :54, `_smooth` :72, `augment_image`
:89, `augment_batch` :129).

The reference's cv2/scipy chain (src/utils/util_data.py:156-275: random
flips, ±10 % shift, ±175° rotation, ±10 % zoom, elastic deformation, each
with probability 0.3) as one gather-based affine resample of the whole
batch and a displacement field smoothed by two 1-D convolutions.

torch cannot replay JAX's threefry, so the draws are an input
(`AugmentDraws`), as the swarm's r1/r2 are: a parity test feeds the raw
draws that `augment_image` makes from its key. `draw_augment` makes them
from a torch generator on the CPU, so a run's draws do not depend on the
device. The four bilinear taps are gathered with zero padding per tap, as
in the JAX package (`grid_sample` would add the rounding of its
normalise-and-unnormalise round trip); the smoothing convolutions run in
fp32 parity (no TF32).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from gan_discovery_pso_tpu_torch.core.device import resolve_device
from gan_discovery_pso_tpu_torch.ops.precision import fp32_parity


class AugmentConfig(NamedTuple):
    prob: float = 0.3  # reference: applied when randint(0,100) > 70
    shift_perc: float = 0.1
    max_angle: float = 175.0
    zoom_perc: float = 0.1
    zoom: bool = False
    elastic: bool = False
    elastic_alpha: tuple = (20.0, 40.0)
    elastic_sigma: float = 7.0


class AugmentDraws(NamedTuple):
    """One image's raw draws per row, in JAX's ranges (`augment_image`'s
    `ks[0..8]`): the 5 branch uniforms [N, 5]; dy, dx in ±shift_perc·size,
    the angle in ±max_angle, the zoom in 1 ± zoom_perc, the elastic branch
    uniform and alpha [N]; the two elastic fields' uniforms [N, H, W]."""

    u: torch.Tensor
    dy: torch.Tensor
    dx: torch.Tensor
    angle: torch.Tensor
    zoom: torch.Tensor
    el: torch.Tensor
    alpha: torch.Tensor
    field_y: torch.Tensor
    field_x: torch.Tensor


def draw_augment(n: int, h: int, w: int, cfg: AugmentConfig, generator: torch.Generator,
                 device=None) -> AugmentDraws:
    """The draws of `n` images from `generator` (a CPU generator), moved to
    `device` (the card when None)."""
    device = resolve_device(device)
    def uni(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=generator)

    d = AugmentDraws(
        u=uni(n, 5),
        dy=uni(n, lo=-cfg.shift_perc * h, hi=cfg.shift_perc * h),
        dx=uni(n, lo=-cfg.shift_perc * w, hi=cfg.shift_perc * w),
        angle=uni(n, lo=-cfg.max_angle, hi=cfg.max_angle),
        zoom=uni(n, lo=1 - cfg.zoom_perc, hi=1 + cfg.zoom_perc),
        el=uni(n),
        alpha=uni(n, lo=cfg.elastic_alpha[0], hi=cfg.elastic_alpha[1]),
        field_y=uni(n, h, w),
        field_x=uni(n, h, w),
    )
    return AugmentDraws(*(t.to(device) for t in d))


def _bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """img [N, C, H, W]; ys, xs [N, H, W] sample coordinates; zero outside."""
    n, c, h, w = img.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    y1, x1 = y0 + 1, x0 + 1
    flat = img.reshape(n, c, h * w)

    def at(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, 1, h * w)
        v = torch.gather(flat, 2, idx.expand(n, c, h * w)).reshape(n, c, h, w)
        return torch.where(inb[:, None], v, torch.zeros((), dtype=v.dtype, device=v.device))

    wy, wx = wy[:, None], wx[:, None]
    return (at(y0, x0) * (1 - wy) * (1 - wx)
            + at(y0, x1) * (1 - wy) * wx
            + at(y1, x0) * wy * (1 - wx)
            + at(y1, x1) * wy * wx)


def _affine_grid(h: int, w: int, angle, zoom, dy, dx, flip_h, flip_v):
    """The inverse-mapped sample grid [N, H, W] of rotate(angle°) + zoom +
    shift + flips about the image centre (cv2's warpAffine convention:
    a positive angle turns counter-clockwise). Every argument is [N]."""
    dev = angle.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    col = (lambda t: t[:, None, None])
    y = yy - col(dy) - cy
    x = xx - col(dx) - cx
    rad = -angle * math.pi / 180.0  # the inverse rotation
    cos, sin = col(torch.cos(rad)), col(torch.sin(rad))
    ys = (x * sin + y * cos) / col(zoom) + cy
    xs = (x * cos - y * sin) / col(zoom) + cx
    ys = torch.where(col(flip_v), (h - 1) - ys, ys)
    xs = torch.where(col(flip_h), (w - 1) - xs, xs)
    return ys, xs


def _smooth(field: torch.Tensor, sigma: float) -> torch.Tensor:
    """A separable gaussian blur of [N, H, W] by two 1-D convolutions, zero
    padded (the elastic displacement smoothing, reference
    util_data.py:179-180)."""
    radius = int(3 * sigma)
    t = torch.arange(-radius, radius + 1, dtype=torch.float32, device=field.device)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = k / torch.sum(k)
    with fp32_parity():
        f = F.conv2d(field[:, None], k.view(1, 1, -1, 1), padding=(radius, 0))
        f = F.conv2d(f, k.view(1, 1, 1, -1), padding=(0, radius))
    return f[:, 0]


def augment_batch(images: torch.Tensor, cfg: AugmentConfig, draws: AugmentDraws
                  ) -> torch.Tensor:
    """[N, C, H, W] → the batch augmented with one independent chain per
    image (branch probabilities and ranges as reference
    util_data.py:234-275). `draws` holds each image's raw draws
    (`draw_augment`, or JAX's for a parity check)."""
    n, c, h, w = images.shape
    u = draws.u
    flip_h, flip_v = u[:, 0] < cfg.prob, u[:, 1] < cfg.prob
    do_shift, do_rot = u[:, 2] < cfg.prob, u[:, 3] < cfg.prob
    do_zoom = (u[:, 4] < cfg.prob) & bool(cfg.zoom)
    zero = torch.zeros((), dtype=torch.float32, device=images.device)
    dy = torch.where(do_shift, draws.dy, zero)
    dx = torch.where(do_shift, draws.dx, zero)
    angle = torch.where(do_rot, draws.angle, zero)
    zoom = torch.where(do_zoom, draws.zoom, zero + 1.0)
    ys, xs = _affine_grid(h, w, angle, zoom, dy, dx, flip_h, flip_v)
    if cfg.elastic:
        do_el = (draws.el < cfg.prob)[:, None, None]
        alpha = draws.alpha[:, None, None]
        dfy = _smooth(draws.field_y * 2 - 1, cfg.elastic_sigma) * alpha
        dfx = _smooth(draws.field_x * 2 - 1, cfg.elastic_sigma) * alpha
        ys = torch.where(do_el, ys + dfy, ys)
        xs = torch.where(do_el, xs + dfx, xs)
    return _bilinear_sample(images, ys, xs)
