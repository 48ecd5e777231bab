"""Shared pipeline context: config, run dir, random streams and device in one
object (counterpart of `gan_discovery_pso_tpu/pipelines/context.py:28-128`).

Every reference entry script repeats the same preamble: yaml load, run-dir
creation, Logger tee, seed_all (e.g. reference
src/training/pso_discovery.py:53-173). `StageContext.create` does it once.
The port adds the device: the card unless the caller names another, and a
host without CUDA raises before a run dir is made.
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


@dataclasses.dataclass
class StageContext:
    cfg: Config
    data_cfg: DataConfig
    run: RunDir
    keys: KeyChain
    ckpt: Checkpointer
    notify: Notifier
    device: torch.device

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

    def dataset(self, split: str = "train", classes=None, drange=None):
        raise NotImplementedError(
            "data loading is not ported yet (ROADMAP A14: data/mnist.py and the "
            "other datasets)")

    def batches(self, ds, batch_size: int, drop_last: bool = True):
        raise NotImplementedError(
            "data loading is not ported yet (ROADMAP A14: data/mnist.py and the "
            "other datasets)")

    def metrics(self, name: str = "history", tensorboard: bool = False) -> MetricsWriter:
        # TB events under general/logs/ like the reference SummaryWriters
        return MetricsWriter(self.run.reports_dir, name, tensorboard=tensorboard,
                             tb_dir=self.run.general_dir / "logs")

    def tee(self) -> Tee:
        return Tee(self.run.reports_dir / "log.txt")
