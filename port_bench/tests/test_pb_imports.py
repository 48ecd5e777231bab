"""What a run loads: after a rehearsal of every cell at a tiny size, no
module whose top-level name is exactly `jax`, `jaxlib`, `flax` or
`gan_discovery_pso_tpu`; the reference alone loads nothing of the program
either. Each look runs in a fresh interpreter, so what other tests import
does not count."""

import json
import subprocess
import sys

from conftest import ROOT, workloads

FORBIDDEN = {"jax", "jaxlib", "flax", "gan_discovery_pso_tpu"}


def loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport json, sys\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_run_of_every_cell_loads_no_jax(tmp_path):
    code = f"""
import sys, time, torch
sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(ROOT / 'port_bench' / 'tests')!r})
from pathlib import Path
from conftest import copy_bench, shrink
from port_bench import harness
root = shrink(copy_bench(Path({str(tmp_path)!r}) / 'bench'))
for w in {json.dumps(workloads())}:
    for trace in (0, 1):
        r = harness.run_cell(w, 5, 0.1, trace, time.perf_counter(), root=root,
                             device=torch.device('cpu'), log=lambda *a, **k: None)
        assert r['correct'], (w, r['checks'])
"""
    top = loaded_after(code)
    assert "gan_discovery_pso_tpu_torch" in top  # the run reached the program
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    top = loaded_after(f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
                       "import port_bench.reference.models, port_bench.reference.pso, "
                       "port_bench.reference.check, port_bench.work.flops")
    assert "port_bench" in top
    assert not top & (FORBIDDEN | {"gan_discovery_pso_tpu_torch"})
