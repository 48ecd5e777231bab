"""Guards of the PyTorch port: it imports no JAX and nothing of the JAX
package, and its entry points do not fall back to the CPU unasked."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from gan_discovery_pso_tpu_torch.core import PsoConfig, resolve_device
from gan_discovery_pso_tpu_torch.pso import make_batched_discovery_runner, make_discovery_runner

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_and_no_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import gan_discovery_pso_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(k for k in sys.modules
                     if k in ("jax", "jaxlib", "flax", "msgpack", "gan_discovery_pso_tpu")
                     or k.startswith(("jax.", "jaxlib.", "flax.", "msgpack.",
                                      "gan_discovery_pso_tpu.")))
        print(len(names), bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 44  # every submodule was imported


def test_port_imports_on_a_host_without_pandas_matplotlib_or_pil():
    """The report writers import their packages inside the functions, so
    every submodule imports where the card's host lacks them."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys

        for missing in ("pandas", "matplotlib", "PIL"):
            sys.modules[missing] = None  # import raises, find_spec gives None
        import gan_discovery_pso_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        from gan_discovery_pso_tpu_torch.analysis.reporting import host_has
        print(len(names), host_has("numpy"), host_has("pandas"), host_has("matplotlib"))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n, *has = proc.stdout.split()
    assert int(n) >= 44 and has == ["True", "False", "False"]


@pytest.mark.parametrize("script", ["chip_smoke.py", "kernel_sweep.py", "profiler_check.py",
                                    "experiments_torch/chain_probe.py"])
def test_card_scripts_import_no_jax(script):
    """Every import statement of the scripts that run on the card, those
    inside functions too, names neither JAX, flax, msgpack nor the JAX
    package."""
    import ast

    tree = ast.parse((REPO / script).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert "torch" in names  # the walk reached the imports inside functions
    roots = {name.split(".")[0] for name in names}
    assert not roots & {"jax", "jaxlib", "flax", "msgpack", "gan_discovery_pso_tpu"}, roots


@pytest.mark.parametrize("factory", [make_batched_discovery_runner, make_discovery_runner])
def test_runner_without_device_raises_on_a_host_without_cuda(factory, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory(PsoConfig(n_iterations=1, n_particles=2, dim_space=2))
    assert resolve_device("cpu") == torch.device("cpu")
