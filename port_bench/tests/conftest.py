"""Fixtures of the benchmark's tests: the `card` marker, the card itself,
and a copy of the benchmark shrunk to a size the CPU runs in a second."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda", 0)


def shrink(root: Path) -> Path:
    """Shrink the copy under `root` in place: 4 particles, 3 iterations, at
    most 2 swarms a call, one call checked, one call traced."""
    for p in (root / "port_bench" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["pso"].update(n_particles=4, n_iterations=3)
        p.write_text(json.dumps(c))
    for p in (root / "port_bench" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t.update(check_calls=1, trace_calls=1)
        if "swarms_per_call" in t:
            t["swarms_per_call"] = min(t["swarms_per_call"], 2)
        p.write_text(json.dumps(t))
    return root


def copy_bench(dest: Path) -> Path:
    """BENCHMARK.json and the benchmark's folder, copied under `dest`."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", dest / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    return dest


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return shrink(copy_bench(tmp_path / "bench"))


def workloads() -> list:
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
