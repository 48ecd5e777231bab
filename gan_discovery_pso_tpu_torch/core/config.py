"""Typed configuration tree loaded from the reference YAML schemas.

The reference drives every stage from monolithic YAML files
(reference configs/dcgan_mnist.yaml, configs/vqvae.yaml,
configs/claro_preprocess.yaml) read ad hoc by each entry script
(e.g. reference src/training/pso_discovery.py:53-87). Here the same YAML
files load unchanged into a dot-accessible `Config` wrapper, and the blocks
the compute path consumes get typed frozen dataclasses so they hash and
compare by value.

PyTorch port: a copy of `gan_discovery_pso_tpu/core/config.py` reduced to
what the ported stages read (`Config`, `load_config`, `cfg_default`,
`PsoConfig`, `AdamConfig` :172-194, `DataConfig` :198-232), so the port
never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Mapping

import yaml


class Config(Mapping):
    """Read-only dot-access view over a nested YAML mapping.

    ``cfg.trainer_pso.n_particles`` and ``cfg['trainer_pso']['n_particles']``
    are equivalent. Missing keys raise ``AttributeError``/``KeyError`` with
    the full path for debuggability.
    """

    __slots__ = ("_data", "_path")

    def __init__(self, data: dict, path: str = "cfg"):
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_path", path)

    def __getattr__(self, name: str) -> Any:
        try:
            value = self._data[name]
        except KeyError:
            raise AttributeError(f"{self._path} has no key {name!r}") from None
        if isinstance(value, dict):
            return Config(value, f"{self._path}.{name}")
        return value

    def __getitem__(self, name: str) -> Any:
        value = self._data[name]
        if isinstance(value, dict):
            return Config(value, f"{self._path}.{name}")
        return value

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def __contains__(self, name: object) -> bool:
        return name in self._data

    def get(self, name: str, default: Any = None) -> Any:
        value = self._data.get(name, default)
        if isinstance(value, dict):
            return Config(value, f"{self._path}.{name}")
        return value

    def to_dict(self) -> dict:
        return _deep_copy(self._data)

    def with_overrides(self, overrides: Mapping[str, Any]) -> "Config":
        """Return a new Config with dotted-key overrides applied.

        Replaces the reference's argparse-over-YAML pattern
        (reference src/training/pso_discovery.py:63-87): e.g.
        ``cfg.with_overrides({"trainer_pso.n_particles": 64})``.
        """
        data = _deep_copy(self._data)
        for dotted, value in overrides.items():
            node = data
            *parents, leaf = dotted.split(".")
            for p in parents:
                node = node.setdefault(p, {})
                if not isinstance(node, dict):
                    raise KeyError(
                        f"override {dotted!r}: {p!r} is a scalar "
                        f"({node!r}), not a block — check the dotted path"
                    )
            node[leaf] = value
        return Config(data, self._path)

    def __repr__(self) -> str:
        return f"Config({self._path}, keys={list(self._data)})"


def _deep_copy(node):
    if isinstance(node, dict):
        return {k: _deep_copy(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_deep_copy(v) for v in node]
    return node


def cfg_default(block: Mapping[str, Any], key: str, default):
    """`block.get(key, default)` with a None-only fallback: an explicit
    falsy value (seed: 0, noise_factor: 0.0, val_fraction: 0.0) is honored,
    only a missing key or an explicit YAML `null` takes the default."""
    v = block.get(key, default) if block is not None else default
    return default if v is None else v


def load_config(path: str | Path, overrides: Mapping[str, Any] | None = None) -> Config:
    """Load a reference-schema YAML config file."""
    with open(path, "r") as f:
        data = yaml.safe_load(f)
    cfg = Config(data, path=Path(path).stem)
    if overrides:
        cfg = cfg.with_overrides(overrides)
    return cfg


# ---------------------------------------------------------------------------
# Typed blocks for the compute path (static under jit).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PsoConfig:
    """PSO hyper-parameters (reference configs/dcgan_mnist.yaml:146-156).

    Note the reference's velocity-term naming swap: the `w_cognitive`-weighted
    term couples the *global* best and the `w_social`-weighted term couples
    the *personal* best (reference src/pso/util_pso.py:43-49). We keep that
    behavior; see pso/swarm.py.
    """

    n_iterations: int = 50
    n_particles: int = 32
    dim_space: int = 2
    tolerance: float = 1e-5
    w_inertia: float = 0.73
    w_cognitive: float = 1.496
    w_social: float = 1.496
    schedule_inertia: bool = False
    early_stopping: bool = False

    @classmethod
    def from_config(cls, block: Mapping[str, Any]) -> "PsoConfig":
        return cls(
            n_iterations=int(block["n_iterations"]),
            n_particles=int(block["n_particles"]),
            dim_space=int(block["dim_space"]),
            tolerance=float(block["tolerance"]),
            w_inertia=float(block["w_inertia"]),
            w_cognitive=float(block["w_cognitive"]),
            w_social=float(block["w_social"]),
            schedule_inertia=bool(block.get("schedule_inertia", False)),
            # dcgan_mnist.yaml calls it early_stopping; the pso_inverter block
            # carries BOTH keys with different meanings: early_stopping=20 is
            # the CNN fine-tune patience, early_stopping_pso is the swarm flag
            # (reference src/training/pso_inverter.py:321). When the
            # PSO-specific key exists it must win.
            early_stopping=bool(
                block["early_stopping_pso"]
                if "early_stopping_pso" in block
                else block.get("early_stopping", False)
            ),
        )


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    """Adam hyper-parameters (reference configs/dcgan_mnist.yaml:183-189)."""

    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    weight_decay: float = 0.0
    name: str = "Adam"  # "Adam" | "RMSprop": train.common.make_optimizer dispatches on it

    @classmethod
    def from_config(cls, block: Mapping[str, Any]) -> "AdamConfig":
        name = str(block.get("name", "Adam"))
        if name not in ("Adam", "RMSprop"):
            raise ValueError(f"unknown optimizer {name!r}")
        return cls(
            lr=float(block["lr"]),
            beta1=float(block.get("beta1", 0.9)),
            beta2=float(block.get("beta2", 0.999)),
            epsilon=float(block.get("epsilon", 1e-8)),
            weight_decay=float(block.get("weight_decay", 0.0)),
            name=name,
        )


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Data block (reference configs/dcgan_mnist.yaml:10-31)."""

    image_size: int = 28
    channel: int = 1
    drange_net: tuple = (-1, 1)
    dataset: str = "mnist"
    iid_classes: tuple = (0, 2, 3, 4, 6, 7, 8, 9)
    ood_classes: tuple = (1, 5)
    data_dir: str = "./data/data_raw"
    interim_dir: str = "./data/interim"
    model_dir: str = "./models"
    reports_dir: str = "./reports"

    @classmethod
    def from_config(cls, block: Mapping[str, Any]) -> "DataConfig":
        def as_classes(v):
            # claro_preprocess.yaml uses dataset-name strings here
            # (configs/claro_preprocess.yaml:14-15); keep them as 1-tuples.
            if isinstance(v, str):
                return (v,)
            return tuple(v) if v is not None else ()

        return cls(
            image_size=int(block["image_size"]),
            channel=int(block["channel"]),
            drange_net=tuple(block.get("drange_net") or (-1, 1)),
            dataset=str(block["dataset"]),
            iid_classes=as_classes(block.get("iid_classes")),
            ood_classes=as_classes(block.get("ood_classes")),
            data_dir=str(block.get("data_dir", "./data/data_raw")),
            interim_dir=str(block.get("interim_dir", "./data/interim")),
            model_dir=str(block.get("model_dir", "./models")),
            reports_dir=str(block.get("reports_dir", "./reports")),
        )
