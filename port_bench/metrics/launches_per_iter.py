"""Kernel-launch API events of the host over the traced calls, per PSO
iteration (the runner and swarm loop's dispatch)."""


def read(run):
    if run.trace is None or not run.trace["launches"]:
        return None
    return run.trace["launches"] / (run.trace["calls"] * run.shape["t"])
