"""The runners' PSO iteration replayed as CUDA graphs (`pso/graphs.py`).

On the CPU: which runners replay (the card, with the models as they are)
and which keep `optimize` (the CPU, the bf16 copies, the sharded runner),
with the span names of a CPU call as before; the static loop that the
graphs run (`_Static`), held bit-equal to `optimize` over two calls that
share its buffers; the hooks' rules; `profiling.cutting`.

On the card (marker `card`, skipped without one; run there with
`python -m pytest tests/test_torch_port_pso_graph.py --noconftest -q`):
(a) a graphed call is bit-equal to the eager `optimize` loop in fp32
parity, every field of the final state and of the history, for the batched
runner, with `fitness_chunk` 64, for the sequential runner (B = 1, early
stop on) and for the inverter; under TF32 with cuDNN's deterministic
algorithms, bit-equal to the eager TF32 loop, which differs from the fp32
one; (b) consecutive
calls with other classes, draws and source images give eager's answers
and leave the first call's tensors as they were; (c) a conv weight and a
BN statistic changed in place between calls are seen; (d) forward hooks
on G and on the assessor receive eager's inputs and outputs, and a
pre-hook makes the call eager; (e) one `pso.capture` over three calls and
a `pso.replay` in every iteration after it, B1 and B2 run once an
iteration by the profiler's kernel events, and their wrappers called only
in the capturing call. Sizes: G z 10 f 16, a ResNet-50 over 28x28 with
drawn BatchNorm statistics."""

import contextlib
import copy
from collections import Counter

import pytest
import torch
from torch import nn
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import gan_discovery_pso_tpu_torch.models.resnet as resnet_mod
from gan_discovery_pso_tpu_torch.core import profiling
from gan_discovery_pso_tpu_torch.core.config import PsoConfig
from gan_discovery_pso_tpu_torch.models import Generator, GeneratorDef, ResNet, ResNetDef
from gan_discovery_pso_tpu_torch.ops.kernels import rescale01_rows, swarm_update
from gan_discovery_pso_tpu_torch.ops.precision import tf32_math
from gan_discovery_pso_tpu_torch.parallel import make_batched_sharded_discovery_runner, make_mesh
from gan_discovery_pso_tpu_torch.pso import (
    OPTIMIZE_IN,
    OPTIMIZE_OUT,
    inverter_fitness,
    make_batched_discovery_runner,
    make_discovery_runner,
    make_inverter_runner,
    optimize,
    state_from_positions,
)
from gan_discovery_pso_tpu_torch.pso import graphs as graphs_mod
from gan_discovery_pso_tpu_torch.pso.runner import discovery_fitness, forward_scope, rows_fitness

Z = 10
GRAPH_SPANS = {"pso.replay", "pso.capture"}
# each wrapper's kernels, by the names the profiler gives their events
KERNEL_EVENTS = {swarm_update: ("swarm_update_kernel",),
                 rescale01_rows: ("rescale_short_kernel", "rescale_long_kernel")}


def _bn_draws_(model: ResNet, seed: int) -> ResNet:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, bn in resnet_mod._conv_bn_pairs(model):
            c = bn.num_features
            bn.weight.copy_(0.5 + torch.rand(c, generator=g))
            bn.bias.copy_(0.5 * torch.randn(c, generator=g))
            bn.running_mean.copy_(0.5 * torch.randn(c, generator=g))
            bn.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=g))
    return model


def _models(device, n_class: int = 8, width: int = 16, seed: int = 0) -> tuple:
    """G and a ResNet-50 with drawn BatchNorm statistics."""
    torch.manual_seed(seed)
    gen = Generator(GeneratorDef(Z, 1, width)).eval()
    cnn = _bn_draws_(ResNet(ResNetDef("ResNet50", 1, n_class)).eval(), seed + 100)
    return gen.to(device), cnn.to(device)


def _draws(hp: PsoConfig, b: int, device, seed: int) -> tuple:
    g = torch.Generator().manual_seed(seed)
    shape = (b, hp.n_particles, hp.dim_space)
    init = state_from_positions(torch.randn(shape, generator=g),
                                (torch.randn(shape, generator=g) - 0.5) / 10, hp.w_inertia)
    init = type(init)(*(x.to(device) for x in init))
    r = torch.rand((2, hp.n_iterations, b, hp.n_particles), generator=g).to(device)
    return init, r[0], r[1]


def _source(n: int, device, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, 1, 28, 28), generator=g) * 2 - 1).to(device)


def _inverter_eager_fitness(gen, cnn, src, class_idx):
    return lambda p: inverter_fitness(p[0], gen, cnn, src, class_idx, control=OPTIMIZE_IN)[None]


def _assert_same(a: tuple, b: tuple) -> None:
    """Every field of (final, history) bit-equal, NaN where NaN."""
    for part_a, part_b in zip(a[:2], b[:2]):
        for name, x, y in zip(part_a._fields, part_a, part_b):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True, msg=name)


def _copied(result: tuple) -> tuple:
    return tuple(type(part)(*(x.clone() for x in part)) for part in result[:2])


def _span_names(fn) -> Counter:
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    names = Counter(s["name"] for s in profiling.spans())
    profiling.clear_spans()
    return names


# --- the CPU ---------------------------------------------------------------

HP_CPU = PsoConfig(n_iterations=3, n_particles=4, dim_space=6)


def _graphs(device: str = "cuda", dtype: torch.dtype | None = None):
    return graphs_mod.IterationGraphs(HP_CPU, torch.device(device), dtype)


@pytest.mark.parametrize("device, dtype, graphed", [
    ("cpu", None, False), ("cpu", torch.bfloat16, False),
    ("cuda", torch.bfloat16, False), ("cuda", None, True)])
def test_only_the_cards_fp32_models_replay_graphs(small, device, dtype, graphed):
    assert _graphs(device, dtype)._applies(small) is graphed


@pytest.fixture(scope="module")
def small():
    torch.manual_seed(0)
    gen = Generator(GeneratorDef(6, 1, 8)).eval()
    cnn = nn.Sequential(nn.Conv2d(1, 4, 3), nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                        nn.Linear(4, 8)).eval()
    return gen, cnn


def _cpu_calls(small) -> dict:
    gen, cnn = small
    rng = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    n, z = HP_CPU.n_particles, HP_CPU.dim_space
    src = _source(n, "cpu", 1)
    pos = torch.randn((n, z), generator=torch.Generator().manual_seed(2))
    return {
        "discovery": lambda: make_batched_discovery_runner(HP_CPU, device="cpu")(
            gen, cnn, [2, 5], rng=rng()),
        "discovery_bf16": lambda: make_batched_discovery_runner(
            HP_CPU, dtype=torch.bfloat16, device="cpu")(gen, cnn, [2, 5], rng=rng()),
        "inverter": lambda: make_inverter_runner(HP_CPU, device="cpu")(
            gen, cnn, 1, src, pos, rng=rng()),
        "sharded": lambda: make_batched_sharded_discovery_runner(
            make_mesh(1, device="cpu"), HP_CPU, class_axis=None)(gen, cnn, [2, 5], rng=rng()),
    }


@pytest.mark.parametrize("kind", ["discovery", "discovery_bf16", "inverter", "sharded"])
def test_cpu_runners_keep_the_eager_loop_and_its_spans(small, kind):
    """The sharded loop records no span of its own."""
    names = _span_names(_cpu_calls(small)[kind])
    assert not GRAPH_SPANS & set(names)
    t = HP_CPU.n_iterations
    if kind != "sharded":
        fitness = {"fitness.generator", "fitness.rescale", "fitness.assessor",
                   "fitness.objective"} | ({"fitness.reconstruction"} if kind == "inverter"
                                           else set())
        want = {"runner.call": 1, "runner.inputs": 1, "pso.stack": 1, "pso.iteration": t,
                "pso.fitness": t, "pso.update": t, "pso.history": t,
                **{name: t for name in fitness}}
        assert dict(names) == want


def _static_cases(small) -> dict:
    """kind → (make_fitness, the closed inputs of two calls, B)."""
    gen, cnn = small
    n = HP_CPU.n_particles

    def discovery(chunk):
        def make(closed):
            return rows_fitness(gen, cnn, closed["row_classes"], n, OPTIMIZE_OUT, 0.0, 0.1,
                                None, chunk)
        rows = [torch.tensor(c).repeat_interleave(chunk or n) for c in ([2, 5], [7, 0])]
        return make, tuple({"row_classes": r} for r in rows), 2

    def make_inverter(closed):
        return _inverter_eager_fitness(gen, cnn, closed["source"], closed["class_idx"])

    inverter = (make_inverter, ({"source": _source(n, "cpu", 1), "class_idx": 3},
                                {"source": _source(n, "cpu", 2), "class_idx": 6}), 1)
    return {"discovery": discovery(None), "discovery_chunk2": discovery(2),
            "inverter": inverter}


@pytest.mark.parametrize("kind", ["discovery", "discovery_chunk2", "inverter"])
def test_the_static_loop_is_optimize_over_two_calls_that_share_its_buffers(small, kind):
    """`_Static` on the CPU: load, T iterations and the copies out give
    `optimize`'s answer bit for bit; a second call with other inputs gives
    its own, and leaves the first's tensors as they were."""
    make, closed, b = _static_cases(small)[kind]
    calls = [(closed[i], *_draws(HP_CPU, b, "cpu", 10 + i)) for i in range(2)]
    with forward_scope(small[1], None):
        static = graphs_mod._Static(HP_CPU, make, *calls[0])
        got = []
        for c, init, r1, r2 in calls:
            static.load(c, init, r1, r2)
            for _ in range(HP_CPU.n_iterations):
                static.iterate()
            got.append(static.results())
        first = _copied(got[0])
        for (c, init, r1, r2), result in zip(calls, got):
            _assert_same(result, optimize(make(c), HP_CPU, init, r1, r2))
    _assert_same(got[0], first)
    assert int(static.t) == HP_CPU.n_iterations


def _hooked(kind: str, model: nn.Module):
    """model, with a hook of `kind` somewhere on it; the handle."""
    if kind == "forward":
        return model.register_forward_hook(lambda *a: None)
    if kind == "forward_pre":
        return model.register_forward_pre_hook(lambda *a: None)
    if kind == "submodule":
        return model[0].register_forward_hook(lambda *a: None)
    if kind == "global":
        return nn.modules.module.register_module_forward_hook(lambda *a: None)
    return contextlib.nullcontext()


@pytest.mark.parametrize("kind, applies", [
    ("none", True), ("forward", True), ("forward_pre", False), ("submodule", False),
    ("global", False)])
def test_hooks_that_a_graph_cannot_honour_make_the_call_eager(small, kind, applies):
    graphs = _graphs()
    handle = _hooked(kind, small[1])
    try:
        assert graphs._applies(small) is applies
    finally:
        if hasattr(handle, "remove"):
            handle.remove()
    assert graphs._applies(small)


@pytest.mark.parametrize("returns", [False, True])
def test_hooks_fire_on_copies_and_a_returned_value_stops_the_replay(small, returns):
    cnn = small[1]
    seen = []
    handle = cnn.register_forward_hook(
        lambda _m, args, out: seen.append((args[0], out)) or (out if returns else None))
    x, out = torch.ones(2, 1, 5, 5), torch.zeros(2, 8)
    try:
        if returns:
            with pytest.raises(graphs_mod.HookReturned) as e:
                graphs_mod._call_hooks(cnn, (x,), out, cnn._forward_hooks)
            assert e.value.args[0] == handle.id
        else:
            graphs_mod._call_hooks(cnn, (x,), out, cnn._forward_hooks)
    finally:
        handle.remove()
    (got_x, got_out), = seen
    assert torch.equal(got_x, x) and torch.equal(got_out, out)
    assert got_x.data_ptr() != x.data_ptr() and got_out.data_ptr() != out.data_ptr()


def test_cutting_hands_each_span_to_the_cut_and_records_nothing():
    met = []
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.cutting(lambda *a: met.append(a)):
            with profiling.span("fitness.assessor", device_time=True):
                with profiling.span("pso.fitness"):
                    pass
        with profiling.span("pso.update"):
            pass
    assert met == [("fitness.assessor", True), ("pso.fitness", False)]
    assert [s["name"] for s in profiling.spans()] == ["pso.update"]
    profiling.clear_spans()


# --- the card ------------------------------------------------------------

HP = PsoConfig(n_iterations=50, n_particles=32, dim_space=Z)
HP_STOP = PsoConfig(n_iterations=50, n_particles=32, dim_space=Z, early_stopping=True,
                    tolerance=5e-2, schedule_inertia=True)
HP_WIDE = PsoConfig(n_iterations=20, n_particles=128, dim_space=Z)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def card_models(card):
    return _models(card), _models(card, n_class=2, seed=1)


def _case(kind: str, card, card_models, seed: int, run=None):
    """(runner call, eager call), runner: one call of `kind`'s runner (`run`,
    or a new one) on the card, with inputs drawn from `seed`."""
    (gen, cnn), (_, binary) = card_models
    hp = _hp(kind)
    if kind == "inverter":
        init, r1, r2 = _draws(hp, 1, card, seed)
        src = _source(hp.n_particles, card, seed)
        run = run or make_inverter_runner(hp, device=card)
        return (lambda: run(gen, binary, 1, src, None, init_state=init, r1=r1, r2=r2),
                lambda: _eager(hp, binary, _inverter_eager_fitness(gen, binary, src, 1),
                               init, r1, r2)), run
    b, chunk = {"batched": (4, None), "chunk64": (2, 64), "sequential": (1, None)}[kind]
    init, r1, r2 = _draws(hp, b, card, seed)
    classes = torch.arange(seed, seed + b, device=card) % 8
    if kind == "sequential":
        run = run or make_discovery_runner(hp, device=card)
        call = lambda: run(gen, cnn, int(classes[0]), init_state=init, r1=r1, r2=r2)  # noqa: E731
    else:
        run = run or make_batched_discovery_runner(hp, fitness_chunk=chunk, device=card)
        call = lambda: run(gen, cnn, classes, init_state=init, r1=r1, r2=r2)  # noqa: E731
    fitness = discovery_fitness(gen, cnn, classes, hp.n_particles, OPTIMIZE_OUT, 0.0, 0.1,
                                None, chunk)
    return (call, lambda: _eager(hp, cnn, fitness, init, r1, r2)), run


def _eager(hp, cnn, fitness, init, r1, r2):
    with forward_scope(cnn, None):
        return optimize(fitness, hp, init, r1, r2)


KINDS = ["batched", "chunk64", "sequential", "inverter"]


def _hp(kind: str) -> PsoConfig:
    return {"chunk64": HP_WIDE, "sequential": HP_STOP}.get(kind.removeprefix("tf32_"), HP)


@contextlib.contextmanager
def _tf32_deterministic():
    """`tf32_math()` with cuDNN held to deterministic algorithms, so that
    two eager TF32 calls agree bit for bit."""
    with tf32_math():
        torch.backends.cudnn.deterministic = True  # tf32_math's exit restores it
        yield


@pytest.mark.card
@pytest.mark.parametrize("kind", KINDS + ["tf32_batched", "tf32_inverter"])
def test_a_graphed_call_is_the_eager_loop(card, card_models, kind):
    """Under TF32 the eager loop runs in the same context, and its answer
    differs from the fp32 loop's, so a graph captured without TF32 fails."""
    tf32 = kind.startswith("tf32_")
    (call, eager), _ = _case(kind.removeprefix("tf32_"), card, card_models, 3)
    scope = _tf32_deterministic if tf32 else contextlib.nullcontext
    with scope():
        want = eager()
        names = [_span_names(call) for _ in range(2)]  # the capture, then replays only
        got = [call(), call()]
    assert names[0]["pso.capture"] == 1 and "pso.capture" not in names[1]
    assert names[1]["pso.replay"] == names[1]["pso.iteration"] == _hp(kind).n_iterations
    for result in got:
        _assert_same(result, want)
    if tf32:
        fp32 = eager()
        assert not torch.equal(want[1].fitness[:, 0], fp32[1].fitness[:, 0])


@pytest.mark.card
@pytest.mark.parametrize("kind", KINDS)
def test_consecutive_calls_give_eager_answers_and_keep_the_first(card, card_models, kind):
    (call_a, eager_a), run = _case(kind, card, card_models, 5)
    (call_b, eager_b), _ = _case(kind, card, card_models, 6, run)
    a = call_a()
    kept = _copied(a)
    b = call_b()
    _assert_same(a, kept)
    _assert_same(a, eager_a())
    _assert_same(b, eager_b())


@pytest.mark.card
@pytest.mark.parametrize("kind", ["batched", "inverter"])
def test_weights_changed_in_place_between_calls_are_seen(card, card_models, kind):
    models = copy.deepcopy(card_models)
    (gen, cnn), (_, binary) = models
    assessor = binary if kind == "inverter" else cnn
    (call, eager), _ = _case(kind, card, models, 7)
    _assert_same(call(), eager())
    with torch.no_grad():
        assessor.layer2[0].conv2.weight.mul_(1.5)
        assessor.layer3[1].bn1.running_var.mul_(3.0)
        gen.gen[0][1].running_mean.add_(0.25)
    _assert_same(call(), eager())


@pytest.mark.card
@pytest.mark.parametrize("kind", ["batched", "inverter"])
def test_forward_hooks_see_eager_forwards_and_a_pre_hook_runs_eager(card, card_models, kind):
    (gen, cnn), (_, binary) = card_models
    assessor = binary if kind == "inverter" else cnn
    (call, eager), _ = _case(kind, card, card_models, 8)
    call()  # the capture

    def recorded(fn):
        seen = {"gen": [], "assessor": []}
        handles = [m.register_forward_hook(
            lambda _m, args, out, key=key: seen[key].append((args[0].clone(), out.clone())))
            for key, m in (("gen", gen), ("assessor", assessor))]
        try:
            names = _span_names(fn)
        finally:
            for h in handles:
                h.remove()
        return seen, names

    want, _ = recorded(eager)
    got, names = recorded(call)
    assert names["pso.replay"] == HP.n_iterations
    for key in want:
        assert len(got[key]) == len(want[key]) == HP.n_iterations
        for (x, y), (u, v) in zip(got[key], want[key]):
            assert torch.equal(x, u) and torch.equal(y, v)
    handle = gen.register_forward_pre_hook(lambda *a: None)
    try:
        names = _span_names(call)
    finally:
        handle.remove()
    assert not GRAPH_SPANS & set(names) and names["pso.iteration"] == HP.n_iterations


@pytest.mark.card
@pytest.mark.parametrize("kind", ["batched", "inverter"])
def test_one_capture_over_three_calls_then_a_replay_an_iteration(card, card_models, kind):
    """B1 and B2 run once an iteration, counted from the profiler's kernel
    events; their wrappers are called in the first iteration and in the
    capture only."""
    (call, _), _ = _case(kind, card, card_models, 9)
    calls = {k: k.launches for k in KERNEL_EVENTS}
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # a session loses its first device events as a rule
        for _ in range(30):
            torch.ones(1, device=card).add_(1)
        torch.cuda.synchronize()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    spans = profiling.spans()
    profiling.clear_spans()
    names = Counter(s["name"] for s in spans)
    t = HP.n_iterations
    assert names["pso.capture"] == 1
    assert names["pso.iteration"] == 3 * t and names["pso.replay"] == 3 * t - 1
    by_id = {s["id"]: s for s in spans}
    assert all(by_id[s["parent"]]["name"] == "pso.iteration"
               for s in spans if s["name"] == "pso.replay")
    runs = {k: sum(e.device_type == DeviceType.CUDA and any(n in e.name for n in names_)
                   for e in prof.events()) for k, names_ in KERNEL_EVENTS.items()}
    assert runs == dict.fromkeys(KERNEL_EVENTS, 3 * t)
    assert {k: k.launches - c for k, c in calls.items()} == dict.fromkeys(KERNEL_EVENTS, 2)
