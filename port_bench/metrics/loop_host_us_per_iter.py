"""Host µs an iteration in the swarm loop's own work: the program's
`pso.update` (inertia, B1, advance) and `pso.history` (the bests' minimum,
the mean pairwise distance, freeze, the record) spans of the traced
calls."""

from port_bench.metrics.iter_host_us import per_iter

NAMES = ("pso.update", "pso.history")


def read(run):
    return per_iter(run, NAMES, "host_ns", 1e-3)
