"""Run one cell of BENCHMARK.json once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the numbers the check compared, each beside its limit, are
the last lines of standard error. Exit codes: 0 with a result; 2 without a
card, or with fewer than the cell asks for; 3 when JAX or the JAX package
was loaded; 1 on any other error (the program missing, for one).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
_CACHE = _HERE / ".cache"
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("CUDA_CACHE_PATH", "nv"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(_CACHE / _sub)
# one process with one host thread: a call's host work is Python and CUDA
# launches on one thread, and needs no pool of CPU workers beside it
os.environ["OMP_NUM_THREADS"] = "1"
sys.path.insert(0, str(_HERE.parent))

from port_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
