#!/usr/bin/env python3
"""Launch-geometry sweep of the port's two CUDA kernels on one NVIDIA card.

Run from the root of a checkout:

    python3 kernel_sweep.py

First it compiles each source of `gan_discovery_pso_tpu_torch/csrc/` once
more with `-Xptxas -v` and prints, per kernel instantiation, its registers
a thread and its spill stores and loads in bytes. Then, for each kernel, it
launches the wrapper with geometries other than the one the wrapper's
helper picks (the wrappers' geometry override), checks each launch against
the plain version, and prints one JSON line per (shape, geometry) with the
device µs per launch from the profiler (chip_smoke.device_us; null where
every session lost its kernel events), inputs cycled past the L2 at the
large shapes:

- rescale01_rows at [256, 784], [1024, 784], [4096, 784]: warps per row
  (team 8, 4, 2, 1) and, for a team of one, rows per CTA (1, 2, 4, 8);
- swarm_update at [8, 32, 100], [32, 32, 100], [1, 32, 100],
  [1, 4096, 1024]: particle rows per CTA (8 to 128).

The "chosen" key marks what `rescale_geometry` / `swarm_geometry` pick.
Last, each kernel through its wrapper at the main path's shape with the L2
flushed before every launch ("l2": "flushed"), as the main path finds the
swarm state after the fitness forward.
It exits non-zero where CUDA is missing. It imports nothing of JAX.
"""

from __future__ import annotations

import itertools
import json
import re
import subprocess
import sys
import tempfile

import chip_smoke as cs


def ptxas_usage(_build) -> list[dict]:
    """Registers a thread and spill bytes of every kernel instantiation, as
    ptxas reports them when it compiles csrc/ with the library's flags."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in _build.SOURCES:
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                   str(_build.CSRC / name), "-o", f"{tmp}/{name}.o"]
            report = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
            kernel = props = None
            for line in report.splitlines():
                found = re.search(r"Compiling entry function '(\w+)'", line)
                if found:
                    kernel = found.group(1)
                found = re.search(r"Function properties for (\w+)", line)
                if found:  # a device function that was not inlined is not a row
                    props = found.group(1)
                spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if spills and kernel and props == kernel:
                    rows.append({"source": name, "kernel": kernel,
                                 "spill_stores": int(spills.group(1)),
                                 "spill_loads": int(spills.group(2))})
                regs = re.search(r"Used (\d+) registers", line)
                if regs and rows and rows[-1]["kernel"] == kernel:
                    rows[-1]["registers"] = int(regs.group(1))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.ROOT))
    from gan_discovery_pso_tpu_torch.ops.kernels import _build, rescale01_rows_plain
    from gan_discovery_pso_tpu_torch.ops.kernels import (
        rescale01_rows, swarm_update, swarm_update_plain)
    from gan_discovery_pso_tpu_torch.ops.kernels.rescale import rescale_geometry
    from gan_discovery_pso_tpu_torch.ops.kernels.swarm_update import swarm_geometry
    from gan_discovery_pso_tpu_torch.pso import state_from_positions

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    for row in ptxas_usage(_build):
        print(json.dumps({"ptxas": row}), flush=True)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = torch.Generator(device=dev).manual_seed(cs.SEED)

    for n in (256, 1024, 4096):
        x = torch.randn((n, 784), generator=rng, device=dev)
        want = rescale01_rows_plain(x)
        sets = cs.copies_for_l2((x,), 8 * n * 784) if n == 4096 else [(x,)]
        chosen = rescale_geometry(n)
        for geometry in ((8, 1), (4, 1), (2, 1), (1, 1), (1, 2), (1, 4), (1, 8)):
            cs.bits_equal(rescale01_rows(x, geometry=geometry), want)
            cycle = itertools.cycle(sets)
            us, _, _ = cs.device_us(lambda: rescale01_rows(*next(cycle), geometry=geometry),
                                 cs.KERNEL_NAMES["rescale01_rows"])
            print(json.dumps({"kernel": "rescale01_rows", "shape": [n, 784],
                              "team": geometry[0], "rows_per_cta": geometry[1],
                              "device_us": us, "chosen": geometry == chosen, "card": card}),
                  flush=True)

    for b, n, d in ((8, 32, 100), (32, 32, 100), (1, 32, 100), (1, 4096, 1024)):
        pos = torch.randn((b, n, d), generator=rng, device=dev)
        s = state_from_positions(pos, pos / 10.0, 0.73)
        fit = (pos * pos).sum(dim=2)
        r = torch.rand((2, b, n), generator=rng, device=dev)
        args = (s.positions, s.velocities, s.p_best_pos, s.p_best_val, fit, r[0], r[1],
                s.g_best_pos, s.g_best_val, s.g_prev_val, torch.full((b,), 0.73, device=dev),
                1.496, 1.496)
        want = swarm_update_plain(*args)
        sets = cs.copies_for_l2(args, 24 * b * n * d) if n == 4096 else [args]
        chosen = swarm_geometry(b, n, sms)
        for rows in (8, 16, 32, 64, 128):
            if rows > max(n, 8):
                continue
            for got, ref in zip(swarm_update(*args, rows_per_cta=rows), want):
                cs.bits_equal(got, ref)
            cycle = itertools.cycle(sets)
            us, _, _ = cs.device_us(lambda: swarm_update(*next(cycle), rows_per_cta=rows),
                                 cs.KERNEL_NAMES["swarm_update"])
            print(json.dumps({"kernel": "swarm_update", "shape": [b, n, d],
                              "rows_per_cta": rows, "tiles": -(-n // rows), "device_us": us,
                              "chosen": rows == chosen, "card": card}), flush=True)
        if (b, n, d) == (cs.N_CLASSES, cs.N_PARTICLES, cs.DIM):
            main_swarm_args = args

    flush = torch.empty(2 * cs.L2_BYTES // 4, device=dev)
    x = torch.randn((cs.N_CLASSES * cs.N_PARTICLES, 784), generator=rng, device=dev)
    for name, fn, shape in (
            ("swarm_update", lambda: swarm_update(*main_swarm_args),
             main_swarm_args[0].shape),
            ("rescale01_rows", lambda: rescale01_rows(x), x.shape)):
        us, profiled, _ = cs.device_us(lambda: (flush.zero_(), fn()), cs.KERNEL_NAMES[name])
        print(json.dumps({"kernel": name, "shape": list(shape), "l2": "flushed",
                          "device_us": us, "profiled_launches": profiled, "chosen": True,
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
