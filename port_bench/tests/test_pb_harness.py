"""The harness, driven end to end on the CPU at a tiny size: every cell
runs and is correct; a cell added as new files only is found and run; each
fault the cells can have turns `correct` false; without a card, or without
the program, there is no result."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, copy_bench, shrink, workloads
from port_bench import harness

import gan_discovery_pso_tpu_torch.pso.fitness as prog_fitness
import gan_discovery_pso_tpu_torch.pso.runner as prog_runner
import gan_discovery_pso_tpu_torch.pso.swarm as prog_swarm

CPU = torch.device("cpu")
SEED = 2**33 + 17  # wider than 32 bits: a check may draw such seeds


def run(root, workload, trace=0, **kw):
    return harness.run_cell(workload, SEED, 0.2, trace, time.perf_counter(), root=root,
                            device=CPU, log=lambda *a, **k: None, **kw)


@pytest.mark.parametrize("workload", workloads())
def test_every_cell_runs_and_is_correct(tiny_root, workload):
    r = run(tiny_root, workload)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    cell = harness.load_cell(tiny_root, workload)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(r)[-1] == "checks"  # the compared numbers come last
    assert set(r["checks"]) >= set(cell.limits)


def test_a_cell_added_as_new_files_is_found_and_run(tiny_root):
    bench = tiny_root / "port_bench"
    cfg = json.loads((bench / "configs" / "dcgan_z10-resnet50.discovery.json").read_text())
    cfg["gan"].update(z_dim=4, features_g=16)
    cfg["pso"]["dim_space"] = 4
    (bench / "configs" / "dcgan_z4-resnet50.new.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "pairs_fp32.json").write_text(json.dumps(
        {"swarms_per_call": 3, "precision": "fp32_parity", "check_calls": 1,
         "trace_calls": 1}))
    (bench / "limits" / "new.pairs_fp32.json").write_text(
        (bench / "limits" / "discovery.batched_fp32.json").read_text())
    (bench / "metrics" / "calls_done.py").write_text(
        "def read(run):\n    return run.window['calls']\n")
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "dcgan_z4-resnet50.new", "source": "test",
                         "file": "port_bench/configs/dcgan_z4-resnet50.new.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "new.pairs_fp32", "config": "dcgan_z4-resnet50.new",
                           "traffic": "pairs_fp32", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "calls_done", "unit": "calls", "better": "higher",
                           "source": "host_clock", "layer": "runner", "moves": "evals_per_s",
                           "workloads": ["new.pairs_fp32"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    r = run(tiny_root, "new.pairs_fp32", trace=1)
    assert r["correct"], r["checks"]
    assert r["metrics"]["calls_done"]["value"] == r["attempted"]



def half_batch(original):
    def fitness(positions, *args, **kw):
        m = positions.shape[0]
        head = original(positions[: m // 2], *args[:2], _rows(args[2], m // 2), *args[3:],
                        **kw)
        vals, imgs = head if isinstance(head, tuple) else (head, None)
        vals = torch.cat([vals, vals.mean().expand(m - m // 2)])
        if imgs is None:
            return vals
        return vals, tuple(torch.cat([i, i[: m - m // 2]]) for i in imgs)
    return fitness


def _rows(class_idx, n):
    return class_idx[:n] if torch.is_tensor(class_idx) and class_idx.dim() else class_idx


def altered_answer(original):
    def fitness(*args, **kw):
        out = original(*args, **kw)
        vals = out[0] if isinstance(out, tuple) else out
        vals = vals.clone()
        vals[0] += 0.25
        return (vals, out[1]) if isinstance(out, tuple) else vals
    return fitness


FAULTS = ("unchanged_state", "half_batch", "altered_answer")


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", workloads())
def test_each_fault_turns_correct_false(tiny_root, monkeypatch, workload, fault):
    if fault == "unchanged_state":
        plain = prog_swarm.swarm_update
        unchanged_state_fn = lambda *a, **k: plain(*a, **k)._replace(  # noqa: E731
            positions=a[0], velocities=a[1])
        monkeypatch.setattr(prog_swarm, "swarm_update", unchanged_state_fn)
    else:
        wrap = half_batch if fault == "half_batch" else altered_answer
        monkeypatch.setattr(prog_runner, "apply_discovery_fitness",
                            wrap(prog_runner.apply_discovery_fitness))
        monkeypatch.setattr(prog_fitness, "apply_discovery_fitness",
                            wrap(prog_fitness.apply_discovery_fitness))
    r = run(tiny_root, workload)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("seed", [0, 7, SEED, 2**31 + 5])
@pytest.mark.parametrize("seconds", [0.2, 12.0, 51.0])
def test_recorded_calls_are_drawn_over_the_window(seed, seconds):
    starts = harness.sample_starts(seed, 3, seconds)
    span = max(seconds - harness.TAIL_S, 0.0)
    # one start in each third of the window before its tail
    assert all(i / 3 * span <= t <= (i + 1) / 3 * span for i, t in enumerate(starts))
    if span:
        assert starts != harness.sample_starts(seed + 1, 3, seconds)


def test_a_fault_late_in_the_window_turns_correct_false(tiny_root, monkeypatch):
    # every answer is altered from the window's fourth call and 60 % of the
    # drawn span on: only a check of calls from the whole window, not of
    # its first calls alone, sees it
    workload = workloads()[0]
    cells = json.loads((tiny_root / "BENCHMARK.json").read_text())["workloads"]
    name = next(c["traffic"] for c in cells if c["name"] == workload)
    traffic = tiny_root / "port_bench" / "traffic" / f"{name}.json"
    t = json.loads(traffic.read_text())
    t["check_calls"] = 3
    traffic.write_text(json.dumps(t))
    seconds = harness.TAIL_S + 3.0
    window = {}
    plain_call = harness.draws_mod.Draws.call

    def call(self, k):
        if k == 0:
            window["t0"] = time.perf_counter()
        window["k"] = k
        return plain_call(self, k)

    def late(original):
        altered = altered_answer(original)

        def fitness(*args, **kw):
            t0 = window.get("t0")
            if t0 is not None and window["k"] >= 3 and time.perf_counter() - t0 >= 0.6 * 3.0:
                return altered(*args, **kw)
            return original(*args, **kw)
        return fitness

    monkeypatch.setattr(harness.draws_mod.Draws, "call", call)
    for mod in (prog_runner, prog_fitness):
        monkeypatch.setattr(mod, "apply_discovery_fitness", late(mod.apply_discovery_fitness))
    r = harness.run_cell(workload, SEED, seconds, 0, time.perf_counter(), root=tiny_root,
                         device=CPU, log=lambda *a, **k: None)
    assert r["checks"]["calls_checked"]["value"] == 3
    assert not r["correct"], r["checks"]


def script(root, *args, env=None):
    return subprocess.run([sys.executable, str(root / "port_bench" / "run.py"), *args],
                          cwd=root, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})})


def test_no_result_without_a_card(tiny_root):
    p = script(ROOT, "--workload", workloads()[0], "--seed", str(SEED), "--seconds", "1",
               "--trace", "0")
    assert p.returncode == 2 and p.stdout == ""
    assert "no result" in p.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    # only BENCHMARK.json and the benchmark's folder: the program is missing
    root = copy_bench(tmp_path / "alone")
    p = script(root, "--workload", workloads()[0], "--seed", "1", "--seconds", "1",
               "--trace", "0", env={"PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout == ""
