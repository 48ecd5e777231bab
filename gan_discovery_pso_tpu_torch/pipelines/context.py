"""Shared pipeline context: config, run dir, random streams, device and data
in one object (counterpart of `gan_discovery_pso_tpu/pipelines/context.py:
28-128`).

Every reference entry script repeats the same preamble: yaml load, run-dir
creation, Logger tee, seed_all, loader construction (e.g. reference
src/training/pso_discovery.py:53-173). `StageContext.create` does it once.
The port adds the device: the card unless the caller names another, and a
host without CUDA raises before a run dir is made. Datasets load onto that
device (`data/mnist.py`).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from gan_discovery_pso_tpu_torch.core.checkpoint import Checkpointer
from gan_discovery_pso_tpu_torch.core.config import Config, DataConfig, cfg_default, load_config
from gan_discovery_pso_tpu_torch.core.device import resolve_device
from gan_discovery_pso_tpu_torch.core.logging import MetricsWriter, Notifier, Tee
from gan_discovery_pso_tpu_torch.core.prng import KeyChain, seed_all
from gan_discovery_pso_tpu_torch.core.rundir import RunDir
from gan_discovery_pso_tpu_torch.data import ImageDataset, epoch_batches, load_mnist


@dataclasses.dataclass
class StageContext:
    cfg: Config
    data_cfg: DataConfig
    run: RunDir
    keys: KeyChain
    ckpt: Checkpointer
    notify: Notifier
    device: torch.device
    # cap on images per dataset load (the CLI's --limit; --tiny caps at 512)
    limit: int | None = None
    _digits_plotted: bool = False

    @classmethod
    def create(
        cls,
        cfg: Config | str | Path,
        module: str,
        overrides=None,
        run_id: int | None = None,
        device=None,
    ) -> "StageContext":
        device = resolve_device(device)
        if not isinstance(cfg, Config):
            cfg = load_config(cfg, overrides=overrides)
        elif overrides:
            cfg = cfg.with_overrides(overrides)
        data_cfg = DataConfig.from_config(cfg.data)
        run = RunDir(
            module,
            data_cfg.dataset,
            reports_root=data_cfg.reports_dir,
            models_root=data_cfg.model_dir,
            interim_root=data_cfg.interim_dir,
            run_id=run_id,
        )
        run.snapshot_config(cfg)
        keys = seed_all(int(cfg_default(cfg, "seed", 42)))
        return cls(cfg=cfg, data_cfg=data_cfg, run=run, keys=keys,
                   ckpt=Checkpointer(run.models_dir), notify=Notifier(), device=device)

    def dataset(self, split: str = "train", classes=None, drange=None) -> ImageDataset:
        """The split, filtered to `classes` (default: the IiD classes), in
        `drange` (default: `data.drange_net`), on the stage's device, cut to
        `limit` images. The first train load of a run writes the
        `general/mnist.png` digit grid where matplotlib is installed."""
        if drange is None:
            drange = self.data_cfg.drange_net
        if classes is None:
            classes = self.data_cfg.iid_classes
        ds = load_mnist(self.data_cfg.data_dir, split=split, classes=classes, drange=drange,
                        image_size=self.data_cfg.image_size, device=self.device)
        if self.limit is not None:
            ds = ImageDataset(ds.images[:self.limit], ds.labels[:self.limit], ds.drange,
                              ds.source)
        if split == "train" and not self._digits_plotted:
            # reference util_mnist.plot_digits via get_public_dataset
            # (util_data.py:70/106)
            from gan_discovery_pso_tpu_torch.analysis import reporting

            self._digits_plotted = True
            if reporting.host_has("matplotlib"):
                reporting.plot_digits(ds, self.run.general_dir / "mnist.png",
                                      seed=int(cfg_default(self.cfg, "seed", 42)))
            else:
                print("[dataset] not writing mnist.png: matplotlib is not installed")
        return ds

    def batches(self, ds: ImageDataset, batch_size: int, drop_last: bool = True):
        """epoch → iterator of (x, y) batches. Epoch e's order comes from the
        stream `epoch_{e}` without consuming it (`KeyChain.peek`), as in the
        JAX package; torch draws another permutation than threefry, so
        parity tests inject the batches. drop_last=True for training (fixed
        shapes, as torch's DataLoader); pass False for validation so a val
        set smaller than a batch still yields one."""

        def make(epoch: int):
            return epoch_batches(ds, batch_size, self.keys.peek(f"epoch_{epoch}"),
                                 drop_last=drop_last)

        return make

    def metrics(self, name: str = "history", tensorboard: bool = False) -> MetricsWriter:
        # TB events under general/logs/ like the reference SummaryWriters
        return MetricsWriter(self.run.reports_dir, name, tensorboard=tensorboard,
                             tb_dir=self.run.general_dir / "logs")

    def tee(self) -> Tee:
        return Tee(self.run.reports_dir / "log.txt")
