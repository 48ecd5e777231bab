"""Host µs an iteration in the models: the program's `fitness.generator`,
`fitness.rescale` and `fitness.assessor` spans of the traced calls."""

from port_bench.metrics.iter_host_us import per_iter

NAMES = ("fitness.generator", "fitness.rescale", "fitness.assessor")


def read(run):
    return per_iter(run, NAMES, "host_ns", 1e-3)
