"""On the card (skipped without one): a tiny run of every cell is correct,
and the check's control, the program's path in the precision below the
cell's (TF32 for fp32 parity, bf16 for TF32), is not. The control at the cells' own sizes is run by
`calibrate.py` (PERF.md gives its readings)."""

import time

import pytest

from conftest import workloads
from port_bench import harness

pytestmark = pytest.mark.card


def run(root, device, workload, control=None):
    return harness.run_cell(workload, 2**33 + 29, 0.5, 0, time.perf_counter(), root=root,
                            device=device, control=control, log=lambda *a, **k: None)


@pytest.mark.parametrize("workload", workloads())
def test_sound_run_is_correct_and_the_control_is_not(tiny_root, cuda_card, workload):
    assert run(tiny_root, cuda_card, workload)["correct"]
    control = run(tiny_root, cuda_card, workload,
                  control=harness.load_cell(tiny_root, workload).control)
    assert not control["correct"], control["checks"]
