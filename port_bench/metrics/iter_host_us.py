"""Host µs of one PSO iteration: the program's `pso.iteration` spans
(`gan_discovery_pso_tpu_torch.core.profiling`) in the traced stretch's
last `trace_calls` runner calls (the lead call left out), per iteration.

`per_iter` is what the span readers share. A program without spans, or a
run with no span or device time recorded, reads None."""


def traced_calls(run):
    """The spans of the traced calls, or None where the program records none."""
    from gan_discovery_pso_tpu_torch.core import profiling

    if not hasattr(profiling, "spans"):
        return None
    spans = profiling.spans()
    n = run.traffic["trace_calls"]
    roots = [s["id"] for s in spans if s["name"] == "runner.call" and s["parent"] is None]
    if len(roots) < n:
        return None
    calls = set(roots[-n:])
    return [s for s in spans if s["call"] in calls]


def per_iter(run, names: tuple, key: str, scale: float = 1.0):
    """Σ span[key] × scale over the traced calls' spans named in `names`,
    per iteration; None where one holds no value."""
    spans = traced_calls(run)
    if spans is None:
        return None
    values = [s[key] for s in spans if s["name"] in names]
    if not values or any(v is None for v in values):
        return None
    return scale * sum(values) / (run.traffic["trace_calls"] * run.shape["t"])


def read(run):
    return per_iter(run, ("pso.iteration",), "host_ns", 1e-3)
