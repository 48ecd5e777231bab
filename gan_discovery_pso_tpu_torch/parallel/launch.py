"""Start ranks in new processes (the port's counterpart of the JAX package's
multi-host launch, `tests/test_multihost.py`'s two processes).

`spawn(fn, world, *args, device=...)` starts `world` processes with
`torch.multiprocessing` (start method `spawn`, so nothing of this process's
CUDA state is inherited), joins each to a process group through a
`FileStore` in a temporary directory (no port to collide on), makes its
device current (`mesh.rank_device`), runs `fn(*args)` and returns every
rank's return value, rank by rank. A rank that raises fails the call with
its traceback; the others are stopped. On a card the kernels are built
once, here, before the ranks start.
"""

from __future__ import annotations

import pickle
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from gan_discovery_pso_tpu_torch.core.device import resolve_device
from gan_discovery_pso_tpu_torch.parallel.mesh import distributed_initialize_if_needed


def _rank_main(rank: int, world: int, tmp: str, device: str, fn, args, t_spawn: float) -> None:
    distributed_initialize_if_needed(f"file://{tmp}/store", world, rank, device=device)
    try:
        spawn.seconds_to_group = time.time() - t_spawn
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(Path(tmp) / f"rank_{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def spawn(fn, world: int, *args, device="cuda") -> list:
    """fn(*args) on `world` new ranks; returns their return values (which
    must pickle: tensors on the CPU). In each rank `spawn.seconds_to_group`
    is the time from this call to its process group being up."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from gan_discovery_pso_tpu_torch.ops.kernels import _build

        _build.build()
    with tempfile.TemporaryDirectory(prefix="gdpt_ranks_") as tmp:
        torch.multiprocessing.spawn(_rank_main, args=(world, tmp, str(device), fn, args,
                                                      time.time()),
                                    nprocs=world, join=True, start_method="spawn")
        out = []
        for rank in range(world):
            with open(Path(tmp) / f"rank_{rank}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


spawn.seconds_to_group = None
