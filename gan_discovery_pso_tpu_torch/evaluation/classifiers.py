"""The KNN classifier battery, the framework's "Inception" posterior
(counterpart of `gan_discovery_pso_tpu/evaluation/classifiers.py`:
`KnnBattery` :26, `train_classifier_battery` :33, `compute_posterior` :50,
`assign_labels` :79, `error_reject_points` :90, `save_battery` /
`load_battery` :131-142).

The reference fits one sklearn KNeighborsClassifier(n_neighbors=5) per IiD
class on the first 80 % of the CAE embeddings (reference
src/training/classifiers.py:174-184). KNN has no fit step, so the battery
is the training embeddings, their labels, the class list and k, and the
posterior of all images for all classes is one device computation
(`ops/knn.py`). `classifiers.msgpack` holds the battery in the JAX layout
(`k` a Python int), byte-equal to the JAX package's file.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gan_discovery_pso_tpu_torch.core.checkpoint import load_pytree, save_pytree
from gan_discovery_pso_tpu_torch.core.device import resolve_device
from gan_discovery_pso_tpu_torch.ops.knn import knn_battery_posterior

# distance entries of one query chunk under chunk_size='auto' (~512 MB fp32)
AUTO_CHUNK_ENTRIES = 128_000_000


class KnnBattery(NamedTuple):
    train_x: torch.Tensor  # [M, D] fp32 embeddings
    train_labels: torch.Tensor  # [M] int32 labels
    classes: torch.Tensor  # [C] int32, the sorted unique labels
    k: int = 5


def train_classifier_battery(encoded_train: np.ndarray, labels: np.ndarray, k: int = 5,
                             val_fraction: float = 0.2, device=None) -> KnnBattery:
    """The battery on the head of the embeddings, the last `val_fraction`
    held out (reference classifiers.py:174-184), on `device` (the CUDA card
    when None); its classes are every label's, the held-out rows' included."""
    device = resolve_device(device)
    n = len(encoded_train)
    val_size = int(n * val_fraction)
    cut = n - val_size if val_size > 0 else n
    return KnnBattery(
        train_x=torch.as_tensor(np.asarray(encoded_train[:cut], np.float32), device=device),
        train_labels=torch.as_tensor(np.asarray(labels[:cut], np.int32), device=device),
        classes=torch.as_tensor(np.unique(np.asarray(labels)).astype(np.int32), device=device),
        k=k)


def auto_chunk(battery: KnnBattery, n_queries: int) -> int | None:
    """The query chunk of chunk_size='auto': None (one matrix) while the
    [Nq, Ntrain] distances stay within AUTO_CHUNK_ENTRIES, else the most
    queries per chunk that do (at least 128)."""
    n_train = max(int(battery.train_x.shape[0]), 1)
    if n_queries * n_train <= AUTO_CHUNK_ENTRIES:
        return None
    return max(128, AUTO_CHUNK_ENTRIES // n_train)


def compute_posterior(battery: KnnBattery, encoding, chunk_size: int | str | None = "auto"
                      ) -> torch.Tensor:
    """p_yx [N, C]: column c is P(class c | image) from the one-vs-all KNN
    (reference util_classifiers.py:35-55), on the battery's device. A host
    array is copied there; a tensor on another device raises."""
    device = battery.train_x.device
    if isinstance(encoding, torch.Tensor) and encoding.device != device:
        raise ValueError(f"queries on {encoding.device}, battery on {device}: move one "
                         "of them first")
    encoding = torch.as_tensor(encoding, dtype=torch.float32, device=device)
    if chunk_size == "auto":
        chunk_size = auto_chunk(battery, encoding.shape[0])
    return knn_battery_posterior(encoding, battery.train_x, battery.train_labels,
                                 battery.classes, k=battery.k, chunk_size=chunk_size)


def assign_labels(battery: KnnBattery, encoding) -> tuple[torch.Tensor, torch.Tensor]:
    """(p_yx, argmax column indices); `battery.classes[idx]` gives the
    labels (reference util_classifiers.py:45-53)."""
    p_yx = compute_posterior(battery, encoding)
    return p_yx, torch.argmax(p_yx, dim=1)


def error_reject_points(y_valid, proba, thresholds=None, t_bin: float = 0.5):
    """The reliability-threshold error/reject sweep of ONE one-vs-all
    classifier (reference classifiers.py:186-213): reliability =
    |1 − proba / t_bin|; for each of the 90 thresholds the reliable
    predictions are kept, %rejected = |kept − V| / V · 100 and %error =
    (1 − accuracy on the kept) · 100 (0 where none is kept). Returns
    (p_rej, p_error, thresholds) as float64 arrays."""
    y_valid = np.asarray(y_valid).astype(int)
    proba = np.asarray(proba, np.float64)
    if thresholds is None:
        thresholds = np.linspace(0.0, 0.9, num=90)
    pred_bin = (proba > t_bin).astype(int)  # KNN predict: the majority vote
    reliability = np.abs(1.0 - proba / t_bin)
    v = len(y_valid)
    p_rej, p_err = [], []
    for ths in thresholds:
        mask = reliability > ths
        kept = int(mask.sum())
        p_rej.append(abs(kept - v) / v * 100.0)
        p_err.append(0.0 if kept == 0
                     else (1.0 - float((y_valid[mask] == pred_bin[mask]).mean())) * 100.0)
    return np.asarray(p_rej), np.asarray(p_err), np.asarray(thresholds)


def save_battery(path, battery: KnnBattery):
    """`classifiers.msgpack` in the JAX layout."""
    return save_pytree(path, {"train_x": battery.train_x, "train_labels": battery.train_labels,
                              "classes": battery.classes, "k": int(battery.k)})


def load_battery(path, device=None) -> KnnBattery:
    """The battery of a `classifiers.msgpack` (either package's), on
    `device` (the CUDA card when None)."""
    device = resolve_device(device)
    d = load_pytree(path)
    return KnnBattery(*(torch.as_tensor(np.asarray(d[k]), device=device)
                        for k in ("train_x", "train_labels", "classes")), k=int(d["k"]))
