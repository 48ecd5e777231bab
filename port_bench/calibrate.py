"""The readings that a cell's limits are set from, in one process: the
check's numbers over sound runs of the program on many seeds, and over its
control on a few: the program's own path in the precision below the
cell's (`limits/<cell>.json`'s `control`).

    python3 port_bench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> ... --control-seeds <n> ... [--out FILE]

Each seed is one run of the cell (`harness.run_cell`, no trace) with a
window of `--seconds`, long enough for the calls the check samples. Prints
one JSON line a run, then each number's largest sound reading and smallest
control reading; `--out` also writes the lines to FILE.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench import harness  # noqa: E402


def quiet(*_a, **_k):
    pass


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    lines = []
    control = harness.load_cell(harness.ROOT, args.workload).control
    runs = [(s, None) for s in args.seeds] + [(s, control) for s in args.control_seeds]
    for seed, control in runs:
        r = harness.run_cell(args.workload, seed, args.seconds, 0, time.perf_counter(),
                             control=control, log=quiet)
        line = {"workload": args.workload, "seed": seed, "control": control,
                "correct": r["correct"], "attempted": r["attempted"],
                "checks": {k: c["value"] for k, c in r["checks"].items()},
                "metrics": {k: m["value"] for k, m in r["metrics"].items()},
                "card": r["device"]["card"]}
        print(json.dumps(line, default=str), flush=True)
        lines.append(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x, default=str) + "\n" for x in lines))
    names = lines[0]["checks"].keys()
    for name in names:
        sound = [x["checks"][name] for x in lines if x["control"] is None]
        ctrl = [x["checks"][name] for x in lines if x["control"] is not None]
        print(f"{name}: sound max {max(sound)!r} over {len(sound)}; control min "
              f"{min(ctrl) if ctrl else None!r} over {len(ctrl)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
