"""Single-holder GPU lease (counterpart of `gan_discovery_pso_tpu/core/
tpulock.py`).

Two processes issuing work to one card at once time-slice it, and every
throughput measurement taken then is wrong (the JAX package's round-4
post-mortem: a sweep leg still training while a benchmark ran). So every
device-using CLI stage takes this lease before its first use of the card,
and blocks, with a visible message, while another holder is alive.

Design, as the JAX lock's: a pidfile holding {pid, holder, started},
created with O_CREAT|O_EXCL, at `gdpt_gpu.lock` in the temporary directory
(`/tmp` unless TMPDIR names another; override: GDPT_GPU_LOCK). A stale
file (its pid no longer alive) or a corrupt one is reaped, so a crashed run
never wedges the queue. The wait is GDPT_GPU_LOCK_WAIT_S seconds (default
7200), with the holder logged once a minute, then TimeoutError. On release
the file is removed only if it is still this process's. The lock is
advisory and host-local.

Not engaged when the stage's device is not CUDA (the tests run on the CPU)
or when GDPT_NO_GPU_LOCK=1.

**Re-entrant for the holder's process tree.** While it holds the lease, the
holder sets GDPT_GPU_LOCK_HOLDER to its pid; a `gpu_lock` that finds the
lock file held by the live pid that this variable names runs under that
lease and neither takes nor releases it. So a stage nested in a holder's
process (a `sweep`'s legs, a script that calls the CLI in-process) and the
processes it starts after taking the lease, which inherit the variable (the
ranks that `pso-discovery --shard-swarm` spawns and that go through the CLI
again), never wait for their own parent.
"""

from __future__ import annotations

import contextlib
import errno
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

HOLDER_ENV = "GDPT_GPU_LOCK_HOLDER"


def lock_path() -> Path:
    default = Path(tempfile.gettempdir()) / "gdpt_gpu.lock"
    return Path(os.environ.get("GDPT_GPU_LOCK", default))


def lock_required(device="cuda") -> bool:
    """The lock matters only for a stage on a CUDA device."""
    if os.environ.get("GDPT_NO_GPU_LOCK") == "1":
        return False
    return torch.device(device).type == "cuda"


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # alive, another user's
        return True
    return True


def current_holder(path: Path | None = None) -> dict | None:
    """The live holder's {pid, holder, started}, or None (absent, stale or
    corrupt)."""
    p = path or lock_path()
    try:
        info = json.loads(p.read_text())
        pid = int(info.get("pid", -1))
    except (FileNotFoundError, json.JSONDecodeError, OSError, ValueError, AttributeError):
        return None
    return info if _pid_alive(pid) else None


def _inherited(p: Path) -> bool:
    """The lock is held by the live process that GDPT_GPU_LOCK_HOLDER names:
    this process or an ancestor that started it while holding the lease."""
    holder = os.environ.get(HOLDER_ENV)
    info = current_holder(p)
    return bool(holder) and info is not None and str(info.get("pid")) == holder


def _try_acquire(p: Path, holder: str) -> bool:
    try:
        fd = os.open(str(p), os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
    except OSError as e:
        if e.errno != errno.EEXIST:
            raise
        info = current_holder(p)
        if info is None:  # stale or corrupt: reap, and try again on the next poll
            with contextlib.suppress(OSError):
                stale = p.read_text()
                p.unlink()
                print(f"[gpulock] reaped stale lock {stale!r}", file=sys.stderr, flush=True)
        return False
    with os.fdopen(fd, "w") as f:
        json.dump({"pid": os.getpid(), "holder": holder, "started": time.time()}, f)
    return True


@contextlib.contextmanager
def gpu_lock(holder: str, wait_s: float | None = None, poll_s: float = 5.0, device="cuda"):
    """Hold the GPU lease for the duration of the context; yields the lock
    file's path, or None where the lock is not engaged or is inherited (see
    the module docstring).

    Blocks up to `wait_s` seconds (default GDPT_GPU_LOCK_WAIT_S or 7200)
    while another holder is alive, logging who holds it once a minute, then
    raises TimeoutError."""
    p = lock_path()
    if not lock_required(device) or _inherited(p):
        yield None
        return
    if wait_s is None:
        wait_s = float(os.environ.get("GDPT_GPU_LOCK_WAIT_S", 7200))
    t0 = time.time()
    last_msg = None
    while not _try_acquire(p, holder):
        waited = time.time() - t0
        if waited >= wait_s:
            raise TimeoutError(f"GPU lock held by {current_holder(p)} after waiting "
                               f"{waited:.0f}s (lock file: {p})")
        if last_msg is None or time.time() - last_msg >= 60.0:
            print(f"[gpulock] waiting for the GPU: held by {current_holder(p)} "
                  f"({waited:.0f}s elapsed)", file=sys.stderr, flush=True)
            last_msg = time.time()
        time.sleep(poll_s)
    saved = os.environ.get(HOLDER_ENV)
    os.environ[HOLDER_ENV] = str(os.getpid())
    try:
        yield p
    finally:
        if saved is None:
            os.environ.pop(HOLDER_ENV, None)
        else:
            os.environ[HOLDER_ENV] = saved
        # release only a file that is still ours
        with contextlib.suppress(FileNotFoundError, json.JSONDecodeError, OSError, ValueError):
            if int(json.loads(p.read_text()).get("pid", -1)) == os.getpid():
                p.unlink()
