"""Run-directory management with the reference's naming contract
(counterpart of `gan_discovery_pso_tpu/core/rundir.py:26-197`).

The reference names each experiment run ``{id:05d}--{module}`` and scans
sibling directories to allocate the next id
(reference src/utils/util_general.py:287-326), and snapshots the config
YAML into the log dir (reference src/training/pso_discovery.py:89-110).
Downstream stages locate upstream artifacts by these directory names, so
the scheme is part of the cross-stage file-system API and is kept
byte-identical to the JAX package's.
"""

from __future__ import annotations

import json
import pickle
import re
import time
from pathlib import Path

import numpy as np
import yaml

_ID_RE = re.compile(r"^(\d+)--(.+)$")


def get_next_run_id(run_root: str | Path, module: str) -> int:
    """Next run id for `module` under `run_root`: max(id) + 1 over the
    directories named ``{id}--{module}`` (everything else is ignored,
    reference src/utils/util_general.py:307-326), starting at 1."""
    run_root = Path(run_root)
    run_id = 1
    if run_root.is_dir():
        for d in run_root.iterdir():
            if not d.is_dir():
                continue
            m = _ID_RE.match(d.name)
            if m is not None and m.group(2) == module:
                run_id = max(run_id, int(m.group(1)) + 1)
    return run_id


def run_name(run_id: int, module: str) -> str:
    return f"{run_id:05d}--{module}"


class RunDir:
    """One experiment run's directory layout:

        <reports_root>/<dataset>/<00001--module>/     reports + log.txt + cfg
        <models_root>/<dataset>/<00001--module>/      checkpoints
        <interim_root>/<dataset>/<00001--module>/     particle pickles etc.
    """

    def __init__(
        self,
        module: str,
        dataset: str,
        reports_root: str | Path = "./reports",
        models_root: str | Path = "./models",
        interim_root: str | Path = "./data/interim",
        run_id: int | None = None,
    ):
        self.module = module
        self.dataset = dataset
        reports_root = Path(reports_root) / dataset
        if run_id is None:
            run_id = get_next_run_id(reports_root, module)
        self.run_id = run_id
        self.name = run_name(run_id, module)

        self.reports_dir = reports_root / self.name
        self.models_dir = Path(models_root) / dataset / self.name
        self.interim_dir = Path(interim_root) / dataset / self.name
        for d in (self.reports_dir, self.models_dir, self.interim_dir):
            d.mkdir(parents=True, exist_ok=True)
        self._t0 = time.time()

    @property
    def general_dir(self) -> Path:
        """`general/`: history pickles, landscapes, timing (reference
        general_reports_dir)."""
        d = self.reports_dir / "general"
        d.mkdir(parents=True, exist_ok=True)
        return d

    @property
    def plot_dir(self) -> Path:
        """`training_plot/`: per-metric curves (reference plot_training_dir)."""
        d = self.reports_dir / "training_plot"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def snapshot_config(self, cfg) -> None:
        """Write the resolved config (reference `configuration.yaml`,
        src/training/pso_discovery.py:102-104)."""
        data = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
        with open(self.reports_dir / "configuration.yaml", "w") as f:
            yaml.safe_dump(data, f, sort_keys=False)

    def write_timing(self, timings: dict) -> None:
        """`timing.json` and its pickle twin `general/timing.pkl`, both with
        the reference's 'overall_time' key (src/training/pso_discovery.py:
        242-251)."""
        payload = {"overall_time": time.time() - self._t0, **timings}
        with open(self.reports_dir / "timing.json", "w") as f:
            json.dump(payload, f, indent=2)
        with open(self.general_dir / "timing.pkl", "wb") as f:
            pickle.dump(payload, f)

    def write_overall_history(self, history: dict) -> None:
        """`general/overall_history.pkl` (the history pickle every reference
        entry script writes at exit) plus a readable JSON twin; leaves JSON
        cannot hold degrade to repr rather than failing the stage."""
        general = self.general_dir
        with open(general / "overall_history.pkl", "wb") as f:
            pickle.dump(history, f)

        def enc(o):
            if isinstance(o, dict):
                return {str(k): enc(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return [enc(v) for v in o]
            if o is None or isinstance(o, (str, bool, int, float)):
                return o
            try:
                a = np.asarray(o)
                if a.ndim == 0:
                    return a.item()
                if a.size <= 65536 and a.dtype.kind in "bifu":
                    return a.tolist()
            except (TypeError, ValueError):
                pass
            return repr(o)

        with open(general / "overall_history.json", "w") as f:
            json.dump(enc(history), f, indent=2, default=repr)

    def __repr__(self):
        return f"RunDir({self.name}, reports={self.reports_dir})"


def resolve_prerequisite(path_template: str, dataset: str | None = None) -> Path:
    """Resolve a `prerequisites:` entry (reference configs/dcgan_mnist.yaml:
    33-44): a plain path, validated to exist so a missing upstream run fails
    at startup rather than mid-pipeline."""
    p = Path(path_template)
    if not p.exists():
        raise FileNotFoundError(
            f"prerequisite artifact dir not found: {p} — run the upstream stage first"
        )
    return p
