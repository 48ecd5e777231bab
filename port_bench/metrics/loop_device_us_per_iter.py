"""Device µs an iteration in the swarm loop's own work: the timing events
of the program's `pso.update` and `pso.history` spans of the traced
calls."""

from port_bench.metrics.iter_host_us import per_iter

NAMES = ("pso.update", "pso.history")


def read(run):
    return per_iter(run, NAMES, "device_us")
