"""The port's spans (`core/profiling.py span`) at the hot path's layer
boundaries, on the CPU: nothing is recorded without a profiler session;
inside one, a discovery and an inverter runner call record one
`runner.call` root, one `pso.iteration` an iteration and the layers under
them, nested and on the profiler's clock; only the spans whose device time
the benchmark reads time the device, from pooled events; the buffer keeps
its bound; an exported fitness graph is the same with the spans in the
code. Tiny sizes:
G z 6 f 8, a one-conv assessor over 8 classes, 5 particles x 3 iterations."""

import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

import gan_discovery_pso_tpu_torch.pso.fitness as fitness_mod
from gan_discovery_pso_tpu_torch.compat.export import export_discovery_fitness
from gan_discovery_pso_tpu_torch.core import profiling
from gan_discovery_pso_tpu_torch.core.config import PsoConfig
from gan_discovery_pso_tpu_torch.models import Generator, GeneratorDef
from gan_discovery_pso_tpu_torch.pso import make_batched_discovery_runner, make_inverter_runner

Z, N, T = 6, 5, 3
HP = PsoConfig(n_iterations=T, n_particles=N, dim_space=Z)
ITERATION = {"pso.fitness", "pso.update", "pso.history"}
FITNESS = {"fitness.generator", "fitness.rescale", "fitness.assessor", "fitness.objective"}


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    gen = Generator(GeneratorDef(Z, 1, 8)).eval()
    cnn = nn.Sequential(nn.Conv2d(1, 4, 3), nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                        nn.Linear(4, 8)).eval()
    return gen, cnn


def discovery_call(models):
    run = make_batched_discovery_runner(HP, device="cpu")
    return run(*models, [2, 5], rng=torch.Generator().manual_seed(0))


def inverter_call(models):
    run = make_inverter_runner(HP, device="cpu")
    src = torch.rand((N, 1, 28, 28), generator=torch.Generator().manual_seed(1)) * 2 - 1
    pos = torch.randn((N, Z), generator=torch.Generator().manual_seed(2))
    return run(*models, 1, src, pos, rng=torch.Generator().manual_seed(0))


CALLS = {"discovery": (discovery_call, set()),
         "inverter": (inverter_call, {"fitness.reconstruction"})}


def recorded(call, models):
    """(the spans of one runner call made inside a CPU profiler session, the
    session's events, its start on the profiler's clock)."""
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call(models)
    return profiling.spans(), prof.events(), prof.profiler.kineto_results.trace_start_ns()


def test_without_a_profiler_nothing_is_recorded_and_span_is_the_shared_noop(models):
    profiling.clear_spans()
    discovery_call(models)
    inverter_call(models)
    assert profiling.spans() == []
    off = profiling.span("pso.update")
    assert off is profiling.span("fitness.assessor", device_time=True)
    with off as inside:
        assert inside is None


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_a_runner_call_records_its_layers_nested_in_one_call(models, kind):
    call, extra = CALLS[kind]
    spans, _, _ = recorded(call, models)
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["runner.call"]
    root = roots[0]
    assert {s["call"] for s in spans} == {root["id"]}

    def children(s):
        return [c["name"] for c in spans if c["parent"] == s["id"]]

    assert children(root) == ["runner.inputs"] + ["pso.iteration"] * T + ["pso.stack"]
    iterations = [s for s in spans if s["name"] == "pso.iteration"]
    for it in iterations:
        assert sorted(children(it)) == sorted(ITERATION)
    for fit in (s for s in spans if s["name"] == "pso.fitness"):
        assert set(children(fit)) == FITNESS | extra
    for s in spans:
        assert s["host_ns"] == s["end_ns"] - s["start_ns"] >= 0
        assert s["device_us"] is None
        if s["parent"] is not None:
            parent = by_id[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
    assert len(spans) == 3 + T * (4 + len(FITNESS | extra))


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_span_stamps_lie_in_their_record_function_ranges(models, kind):
    """Each span's stamps, less the session's start, lie inside its own
    `record_function` event (µs from the same start) within 1 ms."""
    spans, events, t0 = recorded(CALLS[kind][0], models)
    ranges = {}
    for e in events:
        if e.name.startswith(("runner.", "pso.", "fitness.")):
            ranges.setdefault(e.name, []).append(e.time_range)
    for name in ranges:
        ranges[name].sort(key=lambda r: r.start)
    for name, group in ranges.items():
        mine = [s for s in spans if s["name"] == name]
        assert len(mine) == len(group), name
        for s, r in zip(mine, group):
            assert r.start - 1e3 <= (s["start_ns"] - t0) / 1e3
            assert (s["end_ns"] - t0) / 1e3 <= r.end + 1e3


class _Event:
    """A stand-in timing event: `elapsed_time` is the gap between the
    records' order numbers, in ms."""
    made = 0
    clock = 0

    def __init__(self, enable_timing=True):
        _Event.made += 1
        self.at = None

    def record(self, stream):
        _Event.clock += 1
        self.at = _Event.clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


def test_only_the_device_read_spans_time_the_device_from_pooled_events(models,
                                                                        monkeypatch):
    """With CUDA stood in for: `fitness.assessor`, `pso.update` and
    `pso.history` carry device µs, every other span None; a second call
    reuses the first call's events."""
    monkeypatch.setattr(profiling.torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(profiling.torch.cuda, "Event", _Event)
    monkeypatch.setattr(profiling, "_current_stream", lambda: None)
    monkeypatch.setattr(profiling, "_free_events", [])
    _Event.made = 0
    spans, _, _ = recorded(discovery_call, models)
    timed = {"fitness.assessor", "pso.update", "pso.history"}
    for s in spans:
        assert (s["device_us"] is not None) == (s["name"] in timed), s
        if s["device_us"] is not None:
            assert s["device_us"] == 1e3
    assert _Event.made == 2 * len(timed) * T
    recorded(discovery_call, models)
    assert _Event.made == 2 * len(timed) * T
    profiling.clear_spans()


def test_the_buffer_keeps_its_bound(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_BUFFER", 4)
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(10):
            with profiling.span(f"outer{i}"):
                with profiling.span("inner"):
                    pass
    kept = profiling.spans()
    assert [s["name"] for s in kept] == ["outer8", "inner", "outer9", "inner"]
    assert [s["parent"] for s in kept] == [None, kept[0]["id"], None, kept[2]["id"]]
    profiling.clear_spans()
    assert profiling.spans() == []


def _graph(path):
    program = torch.export.load(path)
    return [(n.op, str(n.target)) for n in program.graph.nodes]


def test_exported_fitness_graph_is_the_same_with_spans_in_the_code(models, tmp_path,
                                                                   monkeypatch):
    """The fitness artifact traced with the spans in `apply_discovery_fitness`,
    also inside a profiler session, has the nodes of one traced with the
    spans taken out."""
    gen, cnn = models

    def export(name):
        return _graph(export_discovery_fitness(gen, cnn, 2, Z, 4, tmp_path / name))

    spans_in = export("spans.pt2")
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = export("profiled.pt2")
    assert profiling.spans() == []
    monkeypatch.setattr(fitness_mod, "span", lambda name, device_time=False: profiling._OFF)
    assert spans_in == profiled == export("plain.pt2")
    assert not any("record_function" in target for _, target in spans_in)
