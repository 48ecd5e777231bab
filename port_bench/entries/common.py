"""What the entries share: the measured program's models loaded with the
benchmark's weights, its precision modes, and the capture of a recorded
call's intermediate tensors."""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from gan_discovery_pso_tpu_torch.core.config import PsoConfig
from gan_discovery_pso_tpu_torch.ops.precision import tf32_math


def load(module: nn.Module, state_dict: dict, device) -> nn.Module:
    """`module` (built on the "meta" device) on `device` with the
    benchmark's weights, in eval mode."""
    module = module.to_empty(device=device)
    module.load_state_dict(state_dict, strict=True)
    return module.eval()


def pso_config(cfg: dict) -> PsoConfig:
    return PsoConfig(**cfg["pso"])


def precision(name: str) -> tuple:
    """(the runner's dtype, the context a call runs in) of a precision
    mode: "fp32_parity" (the runner enters it itself), "tf32" (the CLI's
    --fast-math: the stage runs inside `tf32_math()`) or "bf16" (the
    runner's bf16 model copies)."""
    if name == "fp32_parity":
        return None, contextlib.nullcontext
    if name == "tf32":
        return None, tf32_math
    if name == "bf16":
        return torch.bfloat16, contextlib.nullcontext
    raise ValueError(f"unknown precision {name!r}")


def to_host(final, history) -> dict:
    """The call's final swarm state and its history on the host: what the
    stage takes from a runner call."""
    return {"final": {f: getattr(final, f).cpu() for f in final._fields},
            "history": {f: getattr(history, f).cpu() for f in history._fields}}


@contextlib.contextmanager
def capture(record: dict | None, **modules: nn.Module):
    """Inside, every forward of modules[name] appends its input and output
    to record[name + "_in"] and record[name + "_out"]; nothing when record
    is None."""
    if record is None:
        yield
        return

    def hook(name):
        def fn(_mod, args, out):
            record.setdefault(name + "_in", []).append(args[0])
            record.setdefault(name + "_out", []).append(out)
        return fn

    handles = [m.register_forward_hook(hook(name)) for name, m in modules.items()]
    try:
        yield
    finally:
        for h in handles:
            h.remove()
