"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Every `*.cu` file in `gan_discovery_pso_tpu_torch/csrc/` exports plain C
entry points (no PyTorch headers), so a build takes seconds. At first use the
sources are compiled for `sm_90a`, one nvcc per source started together, and
linked into one shared library under `gan_discovery_pso_tpu_torch/_build/`,
named by a hash of every file in `csrc/` (sources and the `*.cuh` headers
they include) and the flags, so an edited source or header rebuilds and an
unchanged tree loads the library already built. A failed build raises with
nvcc's output; nothing falls back.

Nothing here runs at import: the package imports on hosts with no nvcc and
no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("rescale.cu", "swarm_update.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> argtypes, for every entry point of the library; each returns the
# cudaError_t of its launch as an int
_SIGNATURES = {
    # x, out, n, f, out_bf16, team, rows_per_cta, vec, stream
    "gdpt_rescale01_rows": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    "gdpt_swarm_update": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # inputs
        _F, _F,  # w_cognitive, w_social
        _P, _P, _P,  # the two fp32 output buffers, the bool flags
        _I, _I, _I,  # n_swarms, n_particles, dim
        _I, _I,  # rows_per_cta, vec_d
        _P),  # stream
    # pos, pbp, pbv, fit, out_pbp, out_pbv, out_cand, out_idx, n_swarms, n,
    # d, row_offset, rows_per_cta, vec_d, stream
    "gdpt_swarm_pbest_local": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "gdpt_swarm_move": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # pos .. w
        _F, _F,  # w_cognitive, w_social
        _P, _P, _P,  # out_big, out_small, out_appended
        _I, _I, _I, _I, _I,  # n_swarms, n, d, rows_per_cta, vec_d
        _P),  # stream
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(cuda_home) / "bin" / "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.iterdir() if p.is_file()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"libgdpt_kernels_{h.hexdigest()[:16]}.so"


def _run(procs):
    errors = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode:
            errors.append(f"$ {' '.join(cmd)}\n{out}{err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def build() -> Path:
    """Compile the sources (in parallel) and link them into one library;
    returns its path. A library already built from these sources is kept."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}_{threading.get_ident()}"
    objs, procs = [], []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    try:
        _run(procs)
        tmp = so.with_name(f"{so.stem}_{tag}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call. Its entry points are
    looked up once: ctypes keeps each on the library object."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def call(fn, device, *args) -> int:
    """fn(*args, stream) on `device`'s current stream, making `device`
    current only when it is not already; returns fn's cudaError_t."""
    # the raw handle, as PyTorch's own kernel launchers read it, without
    # building a torch.cuda.Stream object on every call
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
