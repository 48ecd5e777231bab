"""CLARO CT preprocessing: square box-crop, clip, normalise, resize, export
(counterpart of `gan_discovery_pso_tpu/data/medical.py`: `square_box` :27,
`crop_box` :45, `normalize01` :58, `preprocess_ct_slice` :69,
`load_slice_image` :108, `slice_loader` :122, `SlidingWindowDataset` :152,
`load_sliding_window_dataset` :180, `prepare_patient_dataset` :224,
`read_box_manifest` :264, `read_patients_info` :285).

The reference medical path (reference src/utils/util_medical_data.py:23-129
and the export driver src/data/dataset_preparation.py:90-103): the short
side of a box grows symmetrically (ceil before, floor after) plus a
`perc_border` margin of ceil(Δ/2)·perc on every edge, and the scan is
zero-padded where the box leaves the frame. The irregular crop and pad run
in numpy on the host, as in the JAX package; the resize runs on the
stage's device (`ops/resize.py`, where the JAX package calls
`jax.image.resize` or PIL): the card unless the caller names another
device (`core/device.py`). TIFFs are read and written by `data/tiff.py`,
so no stage here needs PIL; only the `.png` slice format does, and it is
refused where PIL is missing.
"""

from __future__ import annotations

import ast
import importlib.util
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from gan_discovery_pso_tpu_torch.core.device import resolve_device
from gan_discovery_pso_tpu_torch.data.tiff import read_tiff, write_tiff
from gan_discovery_pso_tpu_torch.data.xlsx import read_manifest
from gan_discovery_pso_tpu_torch.ops.resize import resize_bilinear


class ClipSpec(NamedTuple):
    min: float
    max: float


def square_box(box, perc_border: float = 0.0):
    """[y0, x0, y1, x1] → squared (y0, x0, y1, x1) with the border margin
    (reference get_box, util_medical_data.py:23-94): the short side grows by
    ceil(Δ/2) before and floor(Δ/2) after; every edge then grows by
    border = int(perc_border · ceil(Δ/2))."""
    y0, x0, y1, x1 = (int(v) for v in box)
    l_h, l_w = y1 - y0, x1 - x0
    d1 = math.ceil(abs(l_h - l_w) / 2)
    d2 = math.floor(abs(l_h - l_w) / 2)
    border = int(perc_border * d1)
    if l_h > l_w:
        x0, x1 = x0 - d1, x1 + d2
    elif l_w > l_h:
        y0, y1 = y0 - d1, y1 + d2
    return y0 - border, x0 - border, y1 + border, x1 + border


def crop_box(img: np.ndarray, box, perc_border: float = 0.0) -> np.ndarray:
    """Crop the squared box, zero-padding what lies outside the frame
    (reference get_box's vstack/hstack padding)."""
    y0, x0, y1, x1 = square_box(box, perc_border)
    h, w = img.shape[:2]
    pad_top, pad_left = max(0, -y0), max(0, -x0)
    pad_bot, pad_right = max(0, y1 - h), max(0, x1 - w)
    if pad_top or pad_left or pad_bot or pad_right:
        img = np.pad(img, ((pad_top, pad_bot), (pad_left, pad_right)), mode="constant")
        y0, x0, y1, x1 = y0 + pad_top, x0 + pad_left, y1 + pad_top, x1 + pad_left
    return img[y0:y1, x0:x1]


def normalize01(img: np.ndarray, min_val=None, max_val=None) -> np.ndarray:
    """(img − min)/(max − min) with an optional fixed scale (reference
    util_medical_data.py:97-105: falsy bounds fall back to the data's min and
    max, as the reference's `if not min_val`)."""
    if not min_val:
        min_val = img.min()
    if not max_val:
        max_val = img.max()
    return (img - min_val) / (max_val - min_val)


def _resize(img: np.ndarray, size: int, device) -> np.ndarray:
    """[H, W] → float32 [size, size] through `resize_bilinear` on `device`
    (a resolved device)."""
    x = torch.as_tensor(np.asarray(img, np.float32), device=device)
    return resize_bilinear(x, size).cpu().numpy()


def preprocess_ct_slice(
    img: np.ndarray,
    img_dim: int,
    box=None,
    clip: ClipSpec | None = None,
    scale: ClipSpec | None = None,
    perc_border: float = 0.5,
    device=None,
) -> np.ndarray:
    """One slice (reference loader, util_medical_data.py:107-129): box-crop
    → resize(img_dim) on `device` (the card when None) → clip → normalise.
    Returns [1, H, W] float32.

    The reference records the min and max BEFORE the clip and normalises
    with them when no fixed scale is given (:110,124); kept."""
    device = resolve_device(device)
    img = np.asarray(img, np.float64)
    pre_min, pre_max = img.min(), img.max()
    if box is not None:
        img = crop_box(img, list(box), perc_border=perc_border)
    img = _resize(img, img_dim, device)
    if clip is not None:
        img = np.clip(img, clip.min, clip.max)
    if scale is not None:
        img = normalize01(img, scale.min, scale.max)
    else:
        img = normalize01(img, pre_min, pre_max)
    return img[None, :, :].astype(np.float32)


def load_tiff(path: str | Path) -> np.ndarray:
    return read_tiff(path).astype(np.float64)


def load_slice_image(path: str | Path) -> np.ndarray:
    """A slice by its extension (reference util_data.py:145-154) as float32:
    `.mat` through scipy.io (the array under 'img'), `.tif`/`.tiff` through
    `data/tiff.py`, any other format through PIL, which is refused where
    PIL is not installed."""
    path = Path(path)
    if path.suffix == ".mat":
        import scipy.io as sio

        return np.asarray(sio.loadmat(path)["img"], np.float32)
    if path.suffix.lower() in (".tif", ".tiff"):
        return read_tiff(path).astype(np.float32)
    if importlib.util.find_spec("PIL") is None:
        raise RuntimeError(f"{path}: reading {path.suffix} slices needs PIL, which is not "
                           "installed here; .mat and .tif slices need no package")
    from PIL import Image

    return np.asarray(Image.open(path), np.float32)


def slice_loader(
    path: str | Path,
    img_dim: int,
    rescale_minus_1_plus_1: bool = False,
    fill_nan: float = -1000.0,
    device=None,
) -> np.ndarray:
    """The sliding-window datasets' chain per slice (reference
    util_data.py:277-309): load → NaN fill → resize(img_dim) on `device`
    (the card when None) → per-image min-max to [0, 1] → optionally [-1, 1].
    Returns [1, H, W] float32. Training-time augmentation is not applied
    here: it runs batched on the device (`data/augment.py`)."""
    device = resolve_device(device)
    img = load_slice_image(path)
    if np.isnan(img).any():
        img = np.where(np.isnan(img), np.float32(fill_nan), img)
    if img.shape[0] != img_dim or img.shape[1] != img_dim:
        img = _resize(img, img_dim, device)
    img = normalize01(img.astype(np.float64)).astype(np.float32)
    if rescale_minus_1_plus_1:
        img = ((img - 0.5) * 2.0).astype(np.float32)
    return img[None, :, :]


class SlidingWindowDataset(NamedTuple):
    """The reference's sliding-window CT datasets (DatasetSlidingWindowClaro
    and Aerts, util_data.py:358-420) as one [N, 1, H, W] stack, loaded up
    front (slices are small), as `data/mnist.py` holds MNIST."""

    images: np.ndarray  # [N, 1, H, W] float32
    labels: np.ndarray  # [N] int32
    patient_ids: tuple  # [N] str patient id
    slice_ids: tuple  # [N] str slice id


def _sliding_window_dir(data_dir, cfg_data, flavor: str) -> Path:
    """The two reference classes differ only in the directory layout: claro
    adds the nan_cutoff segment (util_data.py:363), aerts does not (:395)."""
    base = Path(data_dir) / str(cfg_data["channel"]) / str(cfg_data["image_size"])
    if flavor == "claro":
        return base / str(cfg_data["nan_cutoff"])
    if flavor == "aerts":
        return base
    raise ValueError(f"unknown sliding-window flavor {flavor!r}")


def _norm_id(v) -> str:
    """xlsx numeric cells arrive as float (12.0); file names use 12."""
    return str(int(v)) if isinstance(v, float) and v == int(v) else str(v)


def load_sliding_window_dataset(
    manifest: dict[str, list],
    data_dir: str | Path,
    cfg_data,
    flavor: str = "claro",
    step: str = "train",
    extension: str = ".mat",
    device=None,
) -> SlidingWindowDataset:
    """manifest: {'id': [...], 'id_slice': [...], 'label': [...]} (the
    reference's DataFrame rows, util_data.py:377-385,409-417). Each slice is
    `{id}_{id_slice}{extension}` under the flavor's directory and runs
    through `slice_loader` on `device` (the card when None). `step` is
    accepted as in the reference; augmentation runs on the device
    (`data/augment.py`)."""
    device = resolve_device(device)
    img_dir = _sliding_window_dir(data_dir, cfg_data, flavor)
    img_dim = int(cfg_data["image_size"])
    rescale_pm1 = bool(cfg_data.get("rescale_minus_1_plus_1", False))
    imgs, labels, pids, sids = [], [], [], []
    for i, (pid, sid, lab) in enumerate(
        zip(manifest["id"], manifest["id_slice"], manifest["label"])
    ):
        if pid is None or sid is None or lab is None:
            raise ValueError(
                f"manifest row {i}: empty cell (id={pid!r}, id_slice={sid!r}, "
                f"label={lab!r}) — every row needs id, id_slice and label"
            )
        pid_s, sid_s = _norm_id(pid), _norm_id(sid)
        path = img_dir / f"{pid_s}_{sid_s}{extension}"
        imgs.append(slice_loader(path, img_dim, rescale_minus_1_plus_1=rescale_pm1,
                                 device=device))
        labels.append(int(float(lab)))
        pids.append(pid_s)
        sids.append(sid_s)
    return SlidingWindowDataset(
        images=np.stack(imgs, axis=0),
        labels=np.asarray(labels, np.int32),
        patient_ids=tuple(pids),
        slice_ids=tuple(sids),
    )


def prepare_patient_dataset(
    data_dir: str | Path,
    dataset: str,
    slice_ids: list[str],
    image_size: int,
    boxes: dict | None = None,
    clip: ClipSpec | None = None,
    scale: ClipSpec | None = None,
    out_dir: str | Path | None = None,
    device=None,
):
    """The per-patient TIFF sweep → a preprocessed stack [N, 1, H, W], and
    optionally a float32 TIFF of each slice for GAN training (reference
    src/data/dataset_preparation.py:90-103). slice_ids are
    '{patient}_{img}' strings (reference ImgDatasetPreparation,
    util_medical_data.py:131-170); each slice reads
    `{data_dir}/{dataset}/{patient}/images/{slice_id}.tif`, resized on
    `device` (the card when None)."""
    device = resolve_device(device)
    data_dir = Path(data_dir) / dataset
    if out_dir is not None:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
    out, meta = [], []
    for sid in slice_ids:
        patient_id, img_id = sid.split("_", 1)
        img = load_tiff(data_dir / patient_id / "images" / f"{sid}.tif")
        box = boxes.get(sid) if boxes else None
        x = preprocess_ct_slice(img, image_size, box=box, clip=clip, scale=scale,
                                device=device)
        out.append(x)
        meta.append((patient_id, img_id))
        if out_dir is not None:
            write_tiff(Path(out_dir) / f"{sid}.tif", x[0])
    return np.stack(out, axis=0), meta


def read_box_manifest(path: str | Path, box_value: str = "box") -> dict:
    """Box manifest → {img_id: [y0, x0, y1, x1]} (reference
    ImgDatasetPreparation, util_medical_data.py:137-141: indexed by 'img ID';
    the box column holds a list as text, parsed with ast.literal_eval where
    the reference eval()s it)."""
    cols = read_manifest(path)
    out = {}
    for img_id, box in zip(cols["img ID"], cols[box_value]):
        if img_id is None or box is None:
            continue
        out[str(Path(str(img_id)).name)] = list(ast.literal_eval(str(box)))
    return out


def read_patients_info(path: str | Path) -> list[str]:
    """patients_info_{dataset} manifest → ['{patient}_{slice}', ...]
    (reference dataset_preparation.py:81-83: the 'image' column holds
    'subdir/{patient}_{slice}.tif' paths)."""
    cols = read_manifest(path)
    out = []
    for row in cols["image"]:
        if row is None:
            continue
        name = str(row).replace("\\", "/").split("/")[-1]
        out.append(name.split(".tif")[0])
    return out
