"""The span readers (`metrics/iter_host_us.py` and the four beside it) and
the spans' clock. On the CPU the five readers run on the shrunk cells
with `--trace 1`: the host readings are positive, the device readings
absent (no CUDA events off the card). On the card (skipped without one):
a span's device µs agrees with CUDA events around the same work, and the
launch API events of the assessor's kernels lie inside its
`fitness.assessor` span's host interval on the profiler's clock."""

import collections
import time

import pytest
import torch

from conftest import workloads
from port_bench import harness

from gan_discovery_pso_tpu_torch.core import profiling
from gan_discovery_pso_tpu_torch.core.config import PsoConfig
from gan_discovery_pso_tpu_torch.models import Generator, GeneratorDef, ResNet, ResNetDef
from gan_discovery_pso_tpu_torch.ops import fp32_parity
from gan_discovery_pso_tpu_torch.pso import make_batched_discovery_runner

HOST = ("iter_host_us", "models_host_us_per_iter", "loop_host_us_per_iter")
DEVICE = ("assessor_device_us_per_iter", "loop_device_us_per_iter")


@pytest.mark.parametrize("workload", workloads())
def test_span_readers_on_the_cpu(tiny_root, workload):
    r = harness.run_cell(workload, 2**33 + 41, 0.2, 1, time.perf_counter(), root=tiny_root,
                         device=torch.device("cpu"), log=lambda *a, **k: None)
    assert r["correct"], r["checks"]
    for name in HOST:
        assert r["metrics"][name]["value"] > 0, name
        assert r["metrics"][name]["unit"] == "us"
    assert not set(DEVICE) & set(r["metrics"])
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["models_host_us_per_iter"] + m["loop_host_us_per_iter"] < m["iter_host_us"]


def _models(device):
    torch.manual_seed(0)
    gen = Generator(GeneratorDef(10, 1, 64)).to(device).eval()
    cnn = ResNet(ResNetDef("ResNet50", 1, 8)).to(device).eval()
    return gen, cnn


def _launched(prof, lo: int, hi: int) -> collections.Counter:
    """The kernels (by name) whose launch API event starts in [lo, hi]
    (ns, the profiler's clock)."""
    events = prof.profiler.kineto_results.events()
    kernels = {e.correlation_id(): e.name() for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA}
    return collections.Counter(
        kernels.get(e.correlation_id(), "lost") for e in events
        if "LaunchKernel" in e.name() and lo <= e.start_ns() <= hi)


def _between_syncs(prof) -> tuple:
    syncs = sorted((e for e in prof.profiler.kineto_results.events()
                    if e.name() == "cudaDeviceSynchronize"), key=lambda e: e.start_ns())
    return syncs[0].start_ns() + syncs[0].duration_ns(), syncs[-1].start_ns()


@pytest.mark.card
def test_spans_share_the_profilers_clock_on_the_card(cuda_card):
    from torch.profiler import ProfilerActivity, profile

    gen, cnn = _models(cuda_card)
    hp = PsoConfig(n_iterations=2, n_particles=4, dim_space=10)
    run = make_batched_discovery_runner(hp, device=cuda_card)

    def call():
        run(gen, cnn, [1, 6], rng=torch.Generator(device=cuda_card).manual_seed(0))

    x = torch.rand((8, 1, 28, 28), device=cuda_card)
    with fp32_parity(), torch.inference_mode():
        call()
        cnn(x)
        torch.cuda.synchronize()
        # the assessor alone: its launches between two synchronisations
        with profile(activities=[ProfilerActivity.CUDA]) as alone:
            cnn(x)
            torch.cuda.synchronize()
            cnn(x)
            torch.cuda.synchronize()
    want = _launched(alone, *_between_syncs(alone))
    assert sum(want.values()) > 50 and "lost" not in want

    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the harness's session
        call()
        torch.cuda.synchronize()
        call()
        torch.cuda.synchronize()
    roots = [s for s in profiling.spans() if s["name"] == "runner.call"]
    assessor = [s for s in profiling.spans()
                if s["name"] == "fitness.assessor" and s["call"] == roots[-1]["id"]]
    assert len(assessor) == hp.n_iterations
    for s in assessor:
        assert _launched(prof, s["start_ns"], s["end_ns"]) == want
        assert s["device_us"] > 0

    # device µs of a span against CUDA events around the same work
    big = torch.rand((256, 1, 28, 28), device=cuda_card)
    before, after = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    profiling.clear_spans()
    with fp32_parity(), torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]):
        cnn(big)
        torch.cuda.synchronize()
        before.record()
        with profiling.span("probe", device_time=True):
            for _ in range(5):
                cnn(big)
        after.record()
        torch.cuda.synchronize()
    (probe,) = profiling.spans()
    events_us = 1e3 * before.elapsed_time(after)
    assert abs(probe["device_us"] - events_us) <= 0.05 * events_us, (probe, events_us)
    profiling.clear_spans()
