"""Share of the traced calls' PSO iterations that ran from CUDA graphs: the
program's `pso.replay` spans (`gan_discovery_pso_tpu_torch/pso/graphs.py`)
in the traced calls over `trace_calls` × iterations, in %. A program that
records no `pso.replay` span there reads None."""

from port_bench.metrics.iter_host_us import traced_calls


def read(run):
    spans = traced_calls(run)
    if spans is None:
        return None
    replays = sum(s["name"] == "pso.replay" for s in spans)
    if not replays:
        return None
    return 100.0 * replays / (run.traffic["trace_calls"] * run.shape["t"])
