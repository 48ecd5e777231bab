#!/usr/bin/env python3
"""Does torch.profiler keep every launch of a timed kernel? On one NVIDIA
card, from the root of a checkout:

    python3 profiler_check.py [--sessions N] [--final-sessions M]

It builds chip_smoke.py's models and the inputs of its timed phase (B1 at
SWARM_TIMED, B2 at RESCALE_TIMED, after the bit-equality checks that make
them), then profiles each timed shape in sessions
(chip_smoke.profile_session) of each layout of LAYOUTS: 50 calls, as
chip_smoke.py made them before, and PROFILER_LEAD_CALLS more calls before
the 50, as it makes them now. N sessions (default 10) run at the start
and after each step of chip_smoke.py's pipeline phase, and M more (default
50) after the whole phase. It prints one JSON line per (step, layout,
shape): the kept kernel events of each session, how many sessions kept
fewer than 50, how many lost a call that was not among its first calls,
and which calls lost their kernel event (call index: sessions); and a last
line with those counts per step and layout. It exits non-zero where CUDA
is missing. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import json
import sys
import time

import chip_smoke as cs

# session layouts: calls a session makes before its 50 timed ones
LAYOUTS = {"50 calls": 0, f"{cs.PROFILER_LEAD_CALLS} lead calls + 50": cs.PROFILER_LEAD_CALLS}


def probe(step: str, to_time: dict, fns: dict, sessions: int, card: str) -> list:
    """Every timed shape under `sessions` sessions of each layout in
    LAYOUTS; returns the lines printed."""
    lines = []
    for layout, lead_calls in LAYOUTS.items():
        for (name, shape), (args, cold, work) in to_time.items():
            cycle = itertools.cycle(cs.copies_for_l2(args, work) if cold else [args])
            kernel = fns[name]
            fn = lambda: kernel(*next(cycle))  # noqa: E731
            for _ in range(5):
                fn()
            records = [cs.profile_session(fn, cs.KERNEL_NAMES[name], lead_calls=lead_calls)[1]
                       for _ in range(sessions)]
            lost = collections.Counter(i for r in records for i in r["calls_without_kernel"] or [])
            line = {"step": step, "layout": layout, "kernel": name, "shape": list(shape),
                    "sessions": sessions, "kept": [r["kept"] for r in records],
                    "launch_api": sorted({r["launch_api"] for r in records}),
                    "short_sessions": sum(r["kept"] < cs.PROFILED_LAUNCHES for r in records),
                    "not_leading_losses": sum(bool(r["calls_without_kernel"])
                                              and not cs.leading_loss(r) for r in records),
                    "calls_without_kernel": dict(sorted(lost.items())),
                    "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--sessions", type=int, default=10)
    parser.add_argument("--final-sessions", type=int, default=50)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profiler_check: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.ROOT))
    from gan_discovery_pso_tpu_torch.ops.kernels import (
        KERNELS, _build, rescale01_rows, swarm_update)

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    _build.build()
    device = torch.device("cuda", 0)
    models = cs.build_models(device)
    to_time = {}
    for name, check in (("swarm_update", cs.check_swarm_update),
                        ("rescale01_rows", cs.check_rescale)):
        for shape, inputs, work, cold in check(models, device)[1]:
            to_time[(name, tuple(shape))] = (inputs, cold, work[0])
    fns = {"swarm_update": swarm_update, "rescale01_rows": rescale01_rows}
    t0 = time.perf_counter()
    lines = []

    def after(step):
        lines.extend(probe(step, to_time, fns, args.sessions, card))

    after("start")
    cs.pipeline_phase(models, device, KERNELS, card, after_step=after)
    lines.extend(probe("after the pipeline phase", to_time, fns, args.final_sessions, card))
    short = collections.defaultdict(lambda: [0, 0, 0])
    for line in lines:
        key = f"{line['step']}; {line['layout']}"
        short[key][0] += line["short_sessions"]
        short[key][1] += line["not_leading_losses"]
        short[key][2] += line["sessions"]
    print(json.dumps({"short_and_not_leading_of_sessions": short,
                      "seconds": time.perf_counter() - t0, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
