"""Precision policy: fp32 parity, TF32 fast math, or bf16 model forwards.

Counterpart of `gan_discovery_pso_tpu/ops/precision.py`. The JAX package
runs every conv and matmul at `Precision.HIGHEST` unless `fast_math()` is on.
PyTorch's own default on the card runs fp32 convolutions in TF32 (cuDNN),
which keeps about three decimal digits, so the parity mode turns TF32 off
for convolutions and matmuls. It also pins cuDNN to deterministic algorithm
choices, so that two fp32 runs with the same seed give identical results.

`tf32_math()` is the card's counterpart of the JAX package's `fast_math()`
over a whole stage (`cli/main.py:340-350`), which the port's CLI enters for
every stage that runs a model under `--fast-math`: there the multiplies drop
to bf16 passes while accumulation, storage, parameters and optimizer state
stay fp32; here convs and matmuls multiply in TF32, which is the same shape
of change. Inside it, `fp32_parity()` (which the stages and the runners
enter around their models) keeps the TF32 settings, as JAX's DEFAULT
precision wins over the HIGHEST default while `fast_math()` is on.

The bf16 mode of the swarm is not a global switch: the runner casts copies
of the models to bf16 once per call (`cast_model`), and the swarm math
stays fp32. It is asked for by a caller (`fast_math_dtype=torch.bfloat16`,
as the JAX package's `run_pso_discovery_batched` takes a dtype), never by
the CLI, and runs under the process's own settings, which `tf32_math()`
keeps but for TF32.

`POLICIES` names each policy's context, so that an exported artifact
(`compat/export.py`) can carry its policy's name and a loader enter it:
"fp32_parity", "tf32" (fp32 models, `export-model --fast-math`) and "bf16"
(the bf16 model copies, kept so that such artifacts still load).
"""

from __future__ import annotations

import contextlib
import contextvars
import copy

import torch

_TF32 = contextvars.ContextVar("tf32_math", default=False)


def cast_model(model: torch.nn.Module, dtype: torch.dtype | None) -> torch.nn.Module:
    """The model itself when dtype is None, else a copy whose parameters and
    buffers (BN running stats included) are cast to dtype — the JAX
    package's `jax.tree.map(lambda x: x.astype(dtype), params)`."""
    if dtype is None:
        return model
    return copy.deepcopy(model).to(dtype)


@contextlib.contextmanager
def _backend_flags(tf32: bool, deterministic: bool):
    """TF32 for cuDNN convs and cuBLAS matmuls, cuDNN's algorithm choice
    deterministic or not, no autotuning; the previous settings come back on
    exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    cudnn.allow_tf32 = matmul.allow_tf32 = tf32
    cudnn.deterministic = deterministic
    cudnn.benchmark = False
    try:
        yield
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark) = saved


@contextlib.contextmanager
def fp32_parity():
    """Full-fp32 convs and matmuls, deterministic cuDNN algorithms; inside
    `tf32_math()` nothing changes. The previous settings come back on exit."""
    if _TF32.get():
        yield
        return
    with _backend_flags(tf32=False, deterministic=True):
        yield


@contextlib.contextmanager
def highest_precision():
    """Full-fp32 matmuls and convs whatever the context, `tf32_math()`
    included: the JAX package's explicit `precision=Precision.HIGHEST`,
    which its `fast_math()` leaves as it is. cuDNN's determinism setting
    stays the context's. The previous settings come back on exit."""
    with _backend_flags(tf32=False, deterministic=torch.backends.cudnn.deterministic):
        yield


@contextlib.contextmanager
def tf32_math():
    """TF32 convs and matmuls, cuDNN free to pick nondeterministic
    algorithms (the bf16 swarm mode's settings), for everything inside,
    `fp32_parity()` blocks included."""
    token = _TF32.set(True)
    try:
        with _backend_flags(tf32=True, deterministic=False):
            yield
    finally:
        _TF32.reset(token)


def tf32_enabled() -> bool:
    """Whether this context runs inside `tf32_math()`."""
    return _TF32.get()


# policy name -> the context it runs under; "tf32" artifacts hold fp32
# models, "bf16" ones bf16 copies, whose convs TF32 does not touch
POLICIES = {"fp32_parity": fp32_parity, "tf32": tf32_math, "bf16": tf32_math}
