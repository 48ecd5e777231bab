"""Max pooling of the ResNet assessor (counterpart of
`gan_discovery_pso_tpu/ops/pool.py:66,102`): the MaxPool2d(3, 2, 1) stem and
the global AdaptiveMaxPool2d((1, 1)) head — a MAX pool, a reference quirk.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, kernel_size, stride=None, padding=0) -> torch.Tensor:
    """torch max_pool2d, floor mode; padded cells are −inf and never win."""
    return F.max_pool2d(x, kernel_size, stride, padding)


def adaptive_max_pool2d(x: torch.Tensor, output_size=(1, 1)) -> torch.Tensor:
    """torch AdaptiveMaxPool2d; the (1, 1) case is the global max."""
    return F.adaptive_max_pool2d(x, output_size)
