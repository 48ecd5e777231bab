"""Profiling: device traces and timed sections (counterpart of
`gan_discovery_pso_tpu/core/profiling.py`).

- `trace(...)`: a `torch.profiler` session over the enclosed section, CPU
  and CUDA activities (CUDA where the host has it), written as a
  Chrome/TensorBoard trace (`*.pt.trace.json`) into `log_dir`;
- `timed(...)`: wall-clock sections with the card synchronised before and
  after, accumulated into a dict as `RunDir.write_timing` takes it;
- `throughput(...)`: the evals/s record.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path, enabled: bool = True):
    """Profile the enclosed section into `log_dir` (view with TensorBoard's
    profiler plugin or chrome://tracing); yields the profiler, or None when
    not enabled."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof


def _sync(sync) -> None:
    """Wait for the card: the device (or tensor's device) `sync` names, or
    the current one where CUDA is initialised; nothing for the CPU."""
    if isinstance(sync, torch.Tensor):
        sync = sync.device
    if sync is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    device = torch.device(sync)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class timed:
    """with timed(timings, "training_time"): ... — the card synchronised
    before and after, so the span holds the device's work. `sync` is a
    device or a tensor on one (default: the current CUDA device, if any)."""

    def __init__(self, sink: dict, name: str, sync: object | None = None):
        self.sink = sink
        self.name = name
        self.sync = sync

    def __enter__(self):
        _sync(self.sync)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.sync)
        self.sink[self.name] = self.sink.get(self.name, 0.0) + time.perf_counter() - self.t0
        return False


def throughput(n_evals: int, seconds: float) -> dict:
    return {"evals": n_evals, "seconds": seconds, "evals_per_sec": n_evals / seconds}
