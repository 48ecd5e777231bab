"""Assessor training: the binary one-vs-all and the multi-class loops
(counterpart of `gan_discovery_pso_tpu/train/cnn.py`: `EpochCounts` :40,
`counts_to_metrics` :78, `make_cnn_steps` :103, `train_cnn` :143).

Reference src/pso/util_cnn.py:277-493:
- binary mode: labels become `y == label` (:309-311); multi-class mode maps
  them through the assessor's class_to_idx (:420);
- loss = softmax cross-entropy;
- ReduceLROnPlateau on the val loss (factor 0.1 after `scheduler_patience`
  epochs without improvement) and early stopping after `early_stopping`
  epochs without improvement (:357-369);
- the best epoch's weights come back at the end (:377-383).

Epoch metrics come from confusion counts kept on the device, read once per
epoch. Differences from the JAX version, none in the values:
- the model and the optimizer hold the state (the JAX package threads a
  `CnnTrainState` through pure steps), so a step mutates them in place;
- the best weights are kept as a COPY of the state dict: the optimizer
  updates the parameters in place, so a kept reference would silently
  become the last epoch's weights;
- the plateau scale sets each param group's lr to lr·scale, which equals
  the JAX package's scaling of Adam's update (the step is linear in lr).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gan_discovery_pso_tpu_torch.core.config import AdamConfig
from gan_discovery_pso_tpu_torch.train.common import cross_entropy_loss, make_optimizer


class EpochCounts(NamedTuple):
    """Confusion accumulators on the device (per class, one-vs-rest)."""

    loss_sum: torch.Tensor
    n: torch.Tensor
    correct: torch.Tensor
    tp: torch.Tensor  # [C]
    fp: torch.Tensor  # [C]
    fn: torch.Tensor  # [C]

    @classmethod
    def zero(cls, n_class: int, device=None) -> "EpochCounts":
        z = torch.zeros((), device=device)
        zc = torch.zeros((n_class,), device=device)
        return cls(z, z, z, zc, zc, zc)


def _update_counts(counts: EpochCounts, loss, logits, labels) -> EpochCounts:
    preds = torch.argmax(logits, dim=1)
    n_class = logits.shape[1]
    onehot_p = F.one_hot(preds, n_class).float()
    onehot_y = F.one_hot(labels.long(), n_class).float()
    bs = float(labels.shape[0])
    return EpochCounts(
        loss_sum=counts.loss_sum + loss * bs,
        n=counts.n + bs,
        correct=counts.correct + (preds == labels).sum(),
        tp=counts.tp + (onehot_p * onehot_y).sum(dim=0),
        fp=counts.fp + (onehot_p * (1 - onehot_y)).sum(dim=0),
        fn=counts.fn + ((1 - onehot_p) * onehot_y).sum(dim=0),
    )


def counts_to_metrics(counts: EpochCounts, average: str) -> dict:
    """'binary' → the positive class's P/R/F1 (sklearn's f1_score default);
    'macro' → the unweighted class mean (the multipatient loop's average,
    reference util_cnn.py:437-439)."""
    tp, fp, fn = (t.detach().cpu().numpy() for t in (counts.tp, counts.fp, counts.fn))
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        rec = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
    if average == "binary":
        prec, rec, f1 = prec[1], rec[1], f1[1]
    else:
        prec, rec, f1 = prec.mean(), rec.mean(), f1.mean()
    return {"loss": float(counts.loss_sum / counts.n), "acc": float(counts.correct / counts.n),
            "f1": float(f1), "prec": float(prec), "rec": float(rec)}


def make_cnn_steps(model: nn.Module, optimizer: torch.optim.Optimizer):
    """(train_step, eval_step), each (x, y, counts) → counts. Labels arrive
    already mapped (binarized or class_to_idx-remapped by the caller).
    train_step runs the model in train mode (batch BN statistics, running
    ones updated) and takes one optimizer step; eval_step runs it in eval
    mode without gradients."""

    def train_step(x, y, counts: EpochCounts) -> EpochCounts:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(x)
        loss = cross_entropy_loss(logits, y)
        loss.backward()
        optimizer.step()
        return _update_counts(counts, loss.detach(), logits.detach(), y)

    @torch.no_grad()
    def eval_step(x, y, counts: EpochCounts) -> EpochCounts:
        model.eval()
        logits = model(x)
        return _update_counts(counts, cross_entropy_loss(logits, y), logits, y)

    return train_step, eval_step


def _set_lr_scale(optimizer: torch.optim.Optimizer, base_lrs: list, scale: float) -> None:
    for group, lr in zip(optimizer.param_groups, base_lrs):
        group["lr"] = lr * scale


def train_cnn(
    model: nn.Module,
    rdef,
    adam: AdamConfig,
    train_batches: Callable[[int], "iter"],
    val_batches: Callable[[int], "iter"],
    num_epochs: int,
    early_stopping: int = 20,
    scheduler_patience: int = 10000,
    label=None,
    metrics_writer=None,
):
    """Train `model` in place. `label` switches binary mode: y ← (y ==
    label) (reference util_cnn.py:309-311); otherwise labels map through
    rdef.class_to_idx (train_model_multipatient, :420).

    train_batches/val_batches: epoch → iterator of (x, y) batches on the
    model's device (`StageContext.batches`). Metrics average 'binary' in
    binary mode, else 'macro'.

    Returns (model with the best epoch's weights, in eval mode; history, a
    dict of lists; best epoch)."""
    average = "binary" if label is not None else "macro"
    optimizer = make_optimizer(adam, model.parameters())
    device = next(model.parameters()).device
    train_step, eval_step = make_cnn_steps(model, optimizer)

    c2i = rdef.class_to_idx()
    if label is None and not c2i:
        raise ValueError(
            "multipatient mode (label=None) needs rdef.iid_classes to map "
            "dataset labels to logit columns — it is empty")
    lut = torch.zeros(max(max(c2i, default=0) + 1, 1), dtype=torch.int32, device=device)
    for c, i in c2i.items():
        lut[c] = i

    def map_labels(y):
        if label is not None:
            return (y == label).to(torch.int32)
        return lut[y.long()]

    def snapshot() -> dict:
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    history = {k: [] for k in (
        "train_loss", "val_loss", "train_acc", "val_acc", "train_f1", "val_f1",
        "train_prec", "val_prec", "train_rec", "val_rec")}
    base_lrs = [g["lr"] for g in optimizer.param_groups]
    lr_scale = 1.0
    best_loss, best_epoch, best_state = np.inf, num_epochs, snapshot()
    epochs_no_improve, plateau_count = 0, 0

    for epoch in range(num_epochs):
        counts = EpochCounts.zero(rdef.n_class, device)
        for x, y in train_batches(epoch):
            counts = train_step(x, map_labels(y), counts)
        m_tr = counts_to_metrics(counts, average)

        counts = EpochCounts.zero(rdef.n_class, device)
        for x, y in val_batches(epoch):
            counts = eval_step(x, map_labels(y), counts)
        m_va = counts_to_metrics(counts, average)

        for k, m in (("train", m_tr), ("val", m_va)):
            for mk in ("loss", "acc", "f1", "prec", "rec"):
                history[f"{k}_{mk}"].append(m[mk])
        if metrics_writer is not None:
            metrics_writer.append(epoch, **{f"train_{k}": v for k, v in m_tr.items()},
                                  **{f"val_{k}": v for k, v in m_va.items()})

        # scheduler: val-loss plateau → lr x 0.1 (torch ReduceLROnPlateau)
        if m_va["loss"] < best_loss - 1e-12:
            plateau_count = 0
        else:
            plateau_count += 1
            if plateau_count > scheduler_patience:
                lr_scale *= 0.1
                _set_lr_scale(optimizer, base_lrs, lr_scale)
                plateau_count = 0

        # early stopping + best tracking (reference :357-369)
        if m_va["loss"] < best_loss:
            best_loss, best_epoch, best_state = m_va["loss"], epoch, snapshot()
            epochs_no_improve = 0
        else:
            epochs_no_improve += 1
            if epochs_no_improve >= early_stopping:
                break

    model.load_state_dict(best_state)
    return model.eval(), history, best_epoch
