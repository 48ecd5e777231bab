"""MNIST as tensors on the stage's device (counterpart of
`gan_discovery_pso_tpu/data/mnist.py`: `ImageDataset` :28, `load_mnist` :63,
`epoch_batches` :113, `train_val_split` :126).

MNIST fits in device memory (60k x 28x28 fp32 ≈ 188 MB), so the dataset is
normalised once on the host and uploaded; an epoch is a gather over a
permuted index (the reference's torchvision pipeline and `split_MNIST`
class filter, reference src/utils/util_data.py:73-114,
src/utils/util_mnist.py:19-34).

Sources, in order:
1. idx files under `<data_dir>/MNIST/raw/` or `<data_dir>/`
   (`train-images-idx3-ubyte[.gz]` etc.), parsed here;
2. the deterministic synthetic digits (`data/synthetic_digits.py`), flagged
   by `source == "synthetic"`. They are rendered with scipy on the host
   (seconds for the 16000-image train split), so each (n, seed) is
   rendered once per process.

Another `image_size` is resized on `device` by `ops/resize.py` (bilinear,
antialiased when shrinking), where the JAX package calls
`jax.image.resize(..., "bilinear")`: not bit for bit, but within 2e-6 of
the images' range (tests/test_torch_port_claro.py).
"""

from __future__ import annotations

import functools
import gzip
import struct
from pathlib import Path
from typing import Iterator, NamedTuple

import numpy as np
import torch

from gan_discovery_pso_tpu_torch.core.device import resolve_device
from gan_discovery_pso_tpu_torch.data.synthetic_digits import synth_digits
from gan_discovery_pso_tpu_torch.ops.rescale import adjust_dynamic_range
from gan_discovery_pso_tpu_torch.ops.resize import resize_bilinear


class ImageDataset(NamedTuple):
    images: torch.Tensor  # [N, 1, H, W] float32, in drange
    labels: torch.Tensor  # [N] int32
    drange: tuple
    source: str  # "mnist-idx" | "synthetic"


_FILES = {
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find_idx(data_dir: Path, stem: str) -> Path | None:
    for root in (data_dir / "MNIST" / "raw", data_dir):
        for suffix in ("", ".gz"):
            p = root / (stem + suffix)
            if p.exists():
                return p
    return None


@functools.lru_cache(maxsize=4)
def _synthetic(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    images, labels = synth_digits(n, seed=seed)
    images.flags.writeable = labels.flags.writeable = False
    return images, labels


def load_mnist(
    data_dir: str | Path,
    split: str = "train",
    classes=None,
    drange=(-1, 1),
    image_size: int = 28,
    device=None,
) -> ImageDataset:
    """Load (or synthesize) MNIST, filter to `classes`, resize to
    `image_size`, map to `drange`, and put it on `device` (the card when
    None); the resize runs there."""
    device = resolve_device(device)
    data_dir = Path(data_dir)
    img_stem, lab_stem = _FILES[split]
    img_path, lab_path = _find_idx(data_dir, img_stem), _find_idx(data_dir, lab_stem)

    if img_path is not None and lab_path is not None:
        images = _read_idx(img_path).astype(np.float32) / 255.0  # [N,28,28] in [0,1]
        labels = _read_idx(lab_path).astype(np.int32)
        source = "mnist-idx"
    else:
        n = 16000 if split == "train" else 4000
        images, labels = _synthetic(n, 0 if split == "train" else 1)
        source = "synthetic"

    if classes is not None:
        mask = np.isin(labels, np.asarray(list(classes)))
        images, labels = images[mask], labels[mask]

    if image_size != images.shape[-1]:
        images = resize_bilinear(torch.as_tensor(images, device=device),
                                 image_size).cpu().numpy()

    images = adjust_dynamic_range(images, (0, 1), drange)
    # torch.tensor copies: the synthetic arrays are shared across loads
    return ImageDataset(
        images=torch.tensor(images[:, None, :, :], dtype=torch.float32, device=device),
        labels=torch.tensor(labels, dtype=torch.int32, device=device),
        drange=tuple(drange),
        source=source,
    )


def epoch_batches(
    ds: ImageDataset, batch_size: int, generator: torch.Generator, drop_last: bool = True
) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """A shuffled epoch as gathers on the device-resident tensors; the
    permutation is drawn from `generator` on the CPU, so it does not depend
    on the device the data lives on."""
    n = ds.images.shape[0]
    perm = torch.randperm(n, generator=generator).to(ds.images.device)
    n_batches = n // batch_size if drop_last else -(-n // batch_size)
    for b in range(n_batches):
        idx = perm[b * batch_size:(b + 1) * batch_size]
        yield ds.images.index_select(0, idx), ds.labels.index_select(0, idx)


def train_val_split(ds: ImageDataset, val_fraction: float = 0.2
                    ) -> tuple[ImageDataset, ImageDataset]:
    """The last `val_fraction` of the images for validation, unshuffled."""
    n = ds.images.shape[0]
    cut = n - int(n * val_fraction)
    return (
        ImageDataset(ds.images[:cut], ds.labels[:cut], ds.drange, ds.source),
        ImageDataset(ds.images[cut:], ds.labels[cut:], ds.drange, ds.source),
    )
