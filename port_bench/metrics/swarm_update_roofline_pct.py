"""B1's share of its roofline: the least time of one launch by
`work/kernels.py` (bytes over the HBM peak or operations over the fp32
peak), averaged over the traced calls' iterations with the particles that
improved at each, over B1's mean device µs a launch in the traced
stretch."""

import torch

from port_bench import tracing
from port_bench.work.kernels import bound_us, swarm_update_work

KERNELS = ("swarm_update_kernel",)


def improved_counts(history) -> list:
    """Particles whose fitness beat their personal best, per iteration."""
    f = history["fitness"]  # [B, T, N]
    best = torch.full_like(f[:, 0], float("inf"))
    counts = []
    for t in range(f.shape[1]):
        counts.append(int((f[:, t] < best).sum()))
        best = torch.minimum(best, f[:, t])
    return counts


def read(run):
    if run.trace is None:
        return None
    us, events = tracing.kernel_us(run.trace, KERNELS)
    if not events:
        return None
    s = run.shape
    bounds = [bound_us(*swarm_update_work(s["b"], s["n"], s["d"], k))
              for out in run.traced_outs for k in improved_counts(out["history"])]
    return 100.0 * (sum(bounds) / len(bounds)) / (us / events)
