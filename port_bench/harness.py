"""One run of one cell of `BENCHMARK.json`: set-up, the measured window, the
traced stretch (`--trace 1`), the check against the plain reference, and the
result line.

Everything that belongs to one cell is found by name under the benchmark's
folder: the configuration (`BENCHMARK.json`'s `file`), its entry into the
measured program (`entries/<entry>.py`) and its reference check
(`reference/<reference>.py`), both named in the configuration; the traffic
mix (`traffic/<traffic>.json`); the limits of the check
(`limits/<workload>.json`); and one reader per metric
(`metrics/<metric>.py`, whose `read(run)` returns the value, or None where
the run holds nothing to read).

A run:
1. set-up, timed from the start of the process: imports, the kernel
   library's load (built into the program's `_build/` on first use),
   weights made on the device from the seed, one warm-up call at the cell's
   shapes;
2. the window: calls back to back (a closed loop) until `--seconds` have
   passed; the call running then completes and counts. A call ends when its
   final state and history are on the host. `check_calls` calls, drawn from
   the seed over the whole window (`sample_starts`), are recorded: their
   inputs, outputs and the program's intermediate tensors, moved to the
   host once the call has ended;
3. the peak of device memory over the calls that were not recorded (a
   recorded call also holds its records), and a look for JAX in
   `sys.modules`;
4. with `--trace 1`, the traced stretch (`tracing.py`);
5. the check of the recorded calls against the reference, every call's
   answer in range, and the metrics.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from port_bench import draws as draws_mod
from port_bench import tracing, weights
from port_bench.reference import models as ref_models
from port_bench.work import flops
from port_bench.work.peaks import PEAK_FLOPS

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent.name
FORBIDDEN = ("jax", "jaxlib", "flax", "gan_discovery_pso_tpu")
# no recorded call starts in the window's last seconds, so each drawn start
# is reached by a window of calls shorter than this
TAIL_S = 5.0


class NoCard(RuntimeError):
    pass


class JaxLoaded(RuntimeError):
    pass


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_module(root: Path, kind: str, name: str):
    """`<root>/<bench>/<kind>/<name>.py`, loaded by its path."""
    path = root / BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{BENCH}_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: Path):
    return json.loads(path.read_text())


def load_cell(root: Path, workload: str) -> SimpleNamespace:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    limits = _json(root / BENCH / "limits" / f"{workload}.json")

    def mine(metrics):
        return [m for m in metrics if "workloads" not in m or workload in m["workloads"]]

    return SimpleNamespace(
        name=workload, chips=cell["chips"], config=_json(root / cfg_entry["file"]),
        traffic=_json(root / BENCH / "traffic" / f"{cell['traffic']}.json"),
        limits=limits["limits"], control=limits["control"],
        end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]))


def card(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {chips}")
    return torch.device("cuda", 0)


def jax_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{role: state dict} of the configuration's models, drawn from the
    seed on `device`: the same seed gives the same weights."""
    wgen = torch.Generator(device=device).manual_seed(draws_mod.stream_seed(seed, 0))
    return {role: weights.make_state_dict(m, cfg["weights"][role], wgen, device)
            for role, m in ref_models.build(cfg, "meta").items()}


def sample_starts(seed: int, n: int, seconds: float) -> list:
    """n times into the window, drawn from the seed, one in each n-th of its
    span before the last TAIL_S seconds (all 0 where the window is
    shorter): the first call that starts at or after each is recorded."""
    rng = random.Random(seed)
    span = max(seconds - TAIL_S, 0.0)
    return [(i + rng.random()) / n * span for i in range(n)]


def moved(obj, device):
    """obj with every tensor in it (through dicts, lists and tuples) on
    `device`."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: moved(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(moved(v, device) for v in obj)
    return obj


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(workload: str, seed: int, seconds: float, trace: int, t_start: float, *,
             root: Path = ROOT, device: torch.device | None = None,
             control: str | None = None, log=print) -> dict:
    """One run; returns the result line as a dict. `device` None looks for
    the card the cell asks for (NoCard without one); tests pass the CPU."""
    cell = load_cell(root, workload)
    cfg, traffic = cell.config, cell.traffic
    if device is None:
        device = card(cell.chips)
    entries = load_module(root, "entries", cfg["entry"])
    reference = load_module(root, "reference", cfg["reference"])
    precision = control or traffic["precision"]

    # --- set-up
    _sync(device)  # the CUDA context
    t_imports = time.perf_counter()
    state_dicts = make_weights(cfg, seed, device)
    _sync(device)
    t_weights = time.perf_counter()
    entry = entries.Entry(cfg, state_dicts, device, precision)
    del state_dicts  # the program holds its copy; the check draws them again
    draws = draws_mod.Draws(cfg, traffic, seed, device)
    t_program = time.perf_counter()
    entry.call(draws.call(-1))
    _sync(device)
    t_end = time.perf_counter()
    setup_s = t_end - t_start
    log(f"setup {setup_s:.6f} s: imports and card {t_imports - t_start:.6f}, weights "
        f"{t_weights - t_imports:.6f}, program {t_program - t_weights:.6f}, warm-up call "
        f"{t_end - t_program:.6f}", file=sys.stderr)

    # --- the window
    starts = sample_starts(seed, traffic["check_calls"], seconds)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    peak = 0
    call_s, answers, records = [], [], []
    t0 = time.perf_counter()
    k = 0
    while True:
        inputs = draws.call(k)
        c0 = time.perf_counter()
        rec = None
        if len(records) < len(starts) and c0 - t0 >= starts[len(records)]:
            rec = {}
            if cuda:  # the peak of the calls before this one
                peak = max(peak, torch.cuda.max_memory_allocated(device))
        out = entry.call(inputs, rec)
        c1 = time.perf_counter()
        call_s.append(c1 - c0)
        answers.append(out)
        if rec is not None:
            rec.update(inputs=inputs, out=out)
            records.append(moved(rec, "cpu"))
            rec = None
            if cuda:  # the records are off the card: count from here on
                torch.cuda.reset_peak_memory_stats(device)
        else:
            out["history"] = None  # only the answer is kept
        k += 1
        if c1 - t0 >= seconds:
            break
    window_s = c1 - t0
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated(device))
    found = jax_modules()
    if found:
        raise JaxLoaded(f"loaded after the window: {', '.join(found)}")
    ms = sorted(1e3 * c for c in call_s)
    log(f"calls {len(call_s)} in {window_s:.6f} s ({draws.evals_per_call} evaluations each); "
        f"call ms min {ms[0]:.3f} median {ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}",
        file=sys.stderr)

    run = SimpleNamespace(
        setup_s=setup_s, precision=precision, cfg=cfg, traffic=traffic,
        window={"calls": len(call_s), "seconds": window_s, "call_s": call_s,
                "evals": len(call_s) * draws.evals_per_call},
        shape={"b": draws.b, "n": draws.n, "d": draws.d, "t": draws.t,
               "pixels": cfg["image"]["channels"] * cfg["image"]["size"] ** 2},
        trace=None, traced_outs=[])
    card_line = power_limit() if device.type == "cuda" else "cpu"
    result_device = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips if device.type == "cuda" else 0,
        "memory_peak_bytes": peak, "card": card_line}

    # --- the traced stretch
    breakdown = None
    if trace:
        events, run.traced_outs = tracing.record(entry, draws, k, traffic["trace_calls"])
        run.trace = tracing.summarize(events, traffic["trace_calls"])
        del events
        per_call = flops.call_flops(cfg, draws.evals_per_call, draws.encoded_per_call)
        run.window["flops"] = per_call * len(call_s)
        # a CPU rehearsal reads no share of the card's peak
        run.peak_flops = PEAK_FLOPS[precision] if device.type == "cuda" else None
        if run.trace is not None:
            result_device["busy_s"] = run.trace["busy_us"] / 1e6
            result_device["window_s"] = run.trace["window_us"] / 1e6
            breakdown = tracing.breakdown(run.trace)

    # --- the check, once the program's state is freed
    del entry
    failed = sum(not reference.answer_ok(cfg, out) for out in answers)
    numbers = reference.compare(cfg, make_weights(cfg, seed, device), moved(records, device),
                                device) if records else {}
    checks = {name: {"value": numbers.get(name, math.inf), "limit": limit}
              for name, limit in cell.limits.items()}
    correct = len(records) == len(starts) and failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = load_module(root, "metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(call_s), "failed": failed,
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {"calls_checked": {"value": len(records), "limit": len(starts)},
                        "calls_failed": {"value": failed, "limit": 0}, **checks}
    return result


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, args.trace, t_start)
    except NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    except JaxLoaded as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    print(f"card: {result['device']['card']}", file=sys.stderr)
    for name, c in result["checks"].items():
        bound = ">=" if name == "calls_checked" else "<="
        print(f"check {name} {c['value']!r} {bound} {c['limit']!r}", file=sys.stderr)
        if not math.isfinite(c["value"]):
            c["value"] = str(c["value"])  # strict JSON has no inf
    print(json.dumps(result))
    return 0
