"""Serving artifacts: `torch.export` programs with their weights inside
(counterpart of `gan_discovery_pso_tpu/compat/export.py`).

The JAX package lowers a jitted function, weights baked in as constants, to
a serialized StableHLO artifact that any JAX process loads and runs without
that package. Here the artifact is a `torch.export` `.pt2` file: the traced
ATen graph of the port's own forward, with the weights as its parameters
and buffers.

Artifacts:
- generator: z [N, z_dim, 1, 1] fp32 -> images [N, C, 28, 28] (tanh range);
- fitness:   positions [N, d] fp32 -> fitness values [N], the body of
  `pso/fitness.py apply_discovery_fitness` (G -> per-sample rescale ->
  assessor posterior -> objective), whose rescale is B2 as the registered
  operator `gdpt::rescale01_rows` (`ops/kernels/rescale.py`): one node of
  the graph, which launches the CUDA kernel on the card and runs the plain
  version on the CPU.

**What a loading process needs.** Unlike a JAX artifact, which runs in any
JAX process, a fitness artifact runs only where `gdpt::rescale01_rows` is
registered, that is in a process that has imported
`gan_discovery_pso_tpu_torch.ops.kernels` (`load_exported` does). The
generator artifact needs no operator of this package.

**Precision.** The JAX artifact carries its precision in the StableHLO;
a torch program does not: the precision of its convs and matmuls is the
loading process's global backend setting, and PyTorch's default on the card
is TF32 convs. So the artifact names its policy in an extra file
(`precision`: "fp32_parity", or "bf16" for the bf16 model copies of
`--fast-math`), and `load_exported` enters that policy (`ops.precision
.POLICIES`) around every call.

**Devices.** The models are traced from CPU copies and the artifact holds
CPU weights. `load_exported(path, device)` moves the program to `device`
(default: the card; `torch.export.passes.move_to_device_pass` moves the
weights, the constants and the devices the trace recorded): the operator
has a CPU and a CUDA implementation, so one artifact serves both, and
`platforms=` accepts "cuda" and "cpu" only.

Round trip:

    export_generator(gen, z_dim=100, batch=32, path="g.pt2")
    g = load_exported("g.pt2")          # on the card
    imgs = g.call(z)
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import torch
from torch import nn

from gan_discovery_pso_tpu_torch.core.device import resolve_device
from gan_discovery_pso_tpu_torch.ops import kernels  # registers gdpt::rescale01_rows
from gan_discovery_pso_tpu_torch.ops.precision import POLICIES, cast_model

PLATFORMS = ("cuda", "cpu")
POLICY_FILE = "precision"


def check_platforms(platforms) -> None:
    """Raise ValueError naming any platform an artifact cannot serve."""
    bad = [p for p in platforms or () if p not in PLATFORMS]
    if bad:
        raise ValueError(
            f"platforms {bad}: a torch.export artifact runs on {list(PLATFORMS)} only (one "
            "artifact serves both; the port has no TPU lowering)")


def _frozen_cpu_copy(model: nn.Module, dtype: torch.dtype | None) -> nn.Module:
    model = cast_model(copy.deepcopy(model).cpu().eval(), dtype)
    for p in model.parameters():
        p.requires_grad_(False)
    return model


class _Call(nn.Module):
    """A function of the input alone over fixed modules."""

    def __init__(self, fn, **modules):
        super().__init__()
        self.fn = fn
        self.parts = nn.ModuleDict(modules)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x, **self.parts)


def export_callable(module: nn.Module, example_args: tuple, path: str | Path, platforms=None,
                    policy: str = "fp32_parity") -> Path:
    """Trace `module` (on the CPU) at `example_args` under the precision
    `policy` and write the program, its weights and the policy's name to
    `path`."""
    check_platforms(platforms)
    if policy not in POLICIES:
        raise ValueError(f"unknown precision policy {policy!r}; choose from {sorted(POLICIES)}")
    with POLICIES[policy](), torch.no_grad():
        program = torch.export.export(module, tuple(example_args))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, path, extra_files={POLICY_FILE: json.dumps({"policy": policy})})
    return path


class LoadedArtifact:
    """An exported program on a device; `.call(*args)` runs it under the
    artifact's precision policy."""

    def __init__(self, program, policy: str, device: torch.device):
        # the weights, the constants and the devices the trace recorded
        # (its dtype/device assertions) move together
        from torch.export.passes import move_to_device_pass

        self.program = move_to_device_pass(program, device)
        self.policy = policy
        self.device = device
        self.module = self.program.module()

    def call(self, *args):
        with POLICIES[self.policy](), torch.no_grad():
            return self.module(*args)


def load_exported(path: str | Path, device=None) -> LoadedArtifact:
    """Read an artifact and put its weights on `device` (default: the
    card); run it with `.call(*args)`."""
    device = resolve_device(device)
    extra = {POLICY_FILE: ""}
    program = torch.export.load(Path(path), extra_files=extra)
    return LoadedArtifact(program, json.loads(extra[POLICY_FILE])["policy"], device)


def _generator(z, gen):
    return gen(z)


def export_generator(gen: nn.Module, z_dim: int, batch: int, path: str | Path,
                     platforms=None, dtype: torch.dtype | None = None) -> Path:
    """The generator's eval forward as an artifact; dtype=torch.bfloat16
    exports its bf16 copy (`--fast-math`)."""
    module = _Call(_generator, gen=_frozen_cpu_copy(gen, dtype))
    return export_callable(module, (torch.zeros((batch, z_dim, 1, 1)),), path, platforms,
                           policy="fp32_parity" if dtype is None else "bf16")


def export_discovery_fitness(
    gen: nn.Module, assessor: nn.Module, class_idx: int, dim_space: int, batch: int,
    path: str | Path, control: str = "optimize_out_training", threshold: float = 0.0,
    eps: float = 0.1, platforms=None, dtype: torch.dtype | None = None,
) -> Path:
    """The discovery fitness (`apply_discovery_fitness` at the logit column
    `class_idx`) as an artifact, its rescale the registered B2 operator;
    dtype=torch.bfloat16 exports the bf16 model copies (`--fast-math`)."""
    from gan_discovery_pso_tpu_torch.pso.fitness import apply_discovery_fitness

    def fitness(pos, gen, assessor):
        return apply_discovery_fitness(pos, gen, assessor, class_idx, control=control,
                                       threshold=threshold, eps=eps, dtype=dtype,
                                       rescale=kernels.rescale01_per_sample_op)

    module = _Call(fitness, gen=_frozen_cpu_copy(gen, dtype),
                   assessor=_frozen_cpu_copy(assessor, dtype))
    return export_callable(module, (torch.zeros((batch, dim_space)),), path, platforms,
                           policy="fp32_parity" if dtype is None else "bf16")
