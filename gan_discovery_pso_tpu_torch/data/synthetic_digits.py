"""Deterministic procedural digit images — the network-less MNIST stand-in.

Digits are rendered from a 7-segment-style 5×3 glyph grid, upscaled to
28×28, then jittered (shift, scale, rotation, pixel noise) so each class has
intra-class variance a CNN can generalize over. This is NOT MNIST — it
exists so every pipeline stage (GAN training, assessor training, PSO
discovery, inversion, evaluation) runs end-to-end in environments with no
dataset on disk; `ImageDataset.source == "synthetic"` flags it.

PyTorch port: the port's own copy of
`gan_discovery_pso_tpu/data/synthetic_digits.py` (numpy and scipy, the same
code, the same images bit for bit), so the port never imports the JAX
package.
"""

from __future__ import annotations

import numpy as np

# segment layout:   0: top, 1: top-left, 2: top-right, 3: middle,
#                   4: bottom-left, 5: bottom-right, 6: bottom
_SEGMENTS = {
    0: (0, 1, 2, 4, 5, 6),
    1: (2, 5),
    2: (0, 2, 3, 4, 6),
    3: (0, 2, 3, 5, 6),
    4: (1, 2, 3, 5),
    5: (0, 1, 3, 5, 6),
    6: (0, 1, 3, 4, 5, 6),
    7: (0, 2, 5),
    8: (0, 1, 2, 3, 4, 5, 6),
    9: (0, 1, 2, 3, 5, 6),
}


def _glyph(digit: int) -> np.ndarray:
    """5×3 binary glyph from the segment table."""
    g = np.zeros((5, 3), np.float32)
    segs = _SEGMENTS[digit]
    if 0 in segs:
        g[0, :] = 1
    if 3 in segs:
        g[2, :] = 1
    if 6 in segs:
        g[4, :] = 1
    if 1 in segs:
        g[0:3, 0] = 1
    if 2 in segs:
        g[0:3, 2] = 1
    if 4 in segs:
        g[2:5, 0] = 1
    if 5 in segs:
        g[2:5, 2] = 1
    return g


def _render(digit: int, rng: np.random.RandomState, size: int = 28) -> np.ndarray:
    g = _glyph(digit)
    # upscale glyph into a ~20x12 stamp
    stamp = np.kron(g, np.ones((4, 4), np.float32))  # 20x12
    # random affine jitter: scale 0.8-1.2, rotation ±15deg, subpixel shift
    from scipy.ndimage import rotate, zoom

    s = rng.uniform(0.85, 1.15)
    stamp = zoom(stamp, s, order=1)
    stamp = rotate(stamp, rng.uniform(-15, 15), order=1, reshape=True, cval=0.0)
    stamp = np.clip(stamp, 0, 1)

    img = np.zeros((size, size), np.float32)
    h, w = stamp.shape
    h, w = min(h, size), min(w, size)
    max_y, max_x = size - h, size - w
    y0 = int(np.clip(rng.randint(max_y + 1) if max_y > 0 else 0, 0, max_y))
    x0 = int(np.clip(rng.randint(max_x + 1) if max_x > 0 else 0, 0, max_x))
    img[y0 : y0 + h, x0 : x0 + w] = stamp[:h, :w]

    # gaussian blur-ish smoothing + noise for MNIST-like softness
    from scipy.ndimage import gaussian_filter

    img = gaussian_filter(img, sigma=rng.uniform(0.5, 0.9))
    img = img / max(img.max(), 1e-6)
    img = np.clip(img + rng.randn(size, size).astype(np.float32) * 0.03, 0.0, 1.0)
    return img.astype(np.float32)


def synth_digits(n: int, seed: int = 0, size: int = 28):
    """(images [n,size,size] in [0,1], labels [n]) — deterministic in seed."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int32)
    images = np.stack([_render(int(d), rng, size) for d in labels], axis=0)
    return images, labels
