"""Device µs an iteration in the assessor: the timing events of the
program's `fitness.assessor` spans of the traced calls (the stream from
the span's start to its end, idle time inside it included)."""

from port_bench.metrics.iter_host_us import per_iter


def read(run):
    return per_iter(run, ("fitness.assessor",), "device_us")
