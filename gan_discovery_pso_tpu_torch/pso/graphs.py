"""A runner's PSO iteration as CUDA graphs, captured once and replayed for
every later iteration of every call (`pso/runner.py`, on the card).

Eager, each iteration costs the host a few hundred kernel launches (G, the
ResNet-50, the rescale, the swarm update, the history), and the host, not
the card, sets a call's pace. Here one iteration is captured as one CUDA
graph per layer span that holds device work. The cuts fall where the spans
of `optimize` and of the fitness open (`core.profiling.cutting`):
`fitness.generator`, `fitness.rescale`, `fitness.assessor`,
`fitness.objective` (with the inverter's `fitness.reconstruction`; with
`fitness_chunk` each chunk has its own four), `pso.update` and
`pso.history`. The graphs share one memory pool, and each reads what the
one before wrote. Each replays inside its own span, so the span metrics
keep reading per layer; `pso.iteration` and `pso.fitness` stay outside the
graphs, with a `pso.replay` span under `pso.iteration`, and `pso.capture`
spans a capture.

The graphs run the eager loop's own code (`pso_iteration`, `history_row`,
the runner's fitness) on static buffers (`_Static`): the state, r1 and r2,
the history, a counter on the card that picks row t of the draws and of the
history, and what the fitness closes over (the discovery's row classes, the
inverter's source images and class). Each call copies its inputs, and the
assessor's BatchNorm folds that `models.folded_batch_norm` computed for the
call from the weights as they then are, into those buffers, and returns
copies of the final state and of the history. A call that captures runs
its first iteration eagerly on the static buffers, on a side stream (the
capture's warm-up), then captures the next and replays the rest.

The cache holds one capture. Its key is the shapes, the models (their
identity, parameter and buffer pointers and modes), the folded convs and
the precision flags (TF32 for cuDNN and cuBLAS, cuDNN's `deterministic`
and `benchmark`). A miss captures again; a capture that fails raises.

Forward hooks on the models themselves fire after their forward's graph,
in eager order, each on copies of that forward's arguments and output. A
forward pre-hook, a hook on a submodule or a global hook makes the call run
`optimize` eagerly, since a graph cannot honour it. So does a hook that
returns a value: the call then runs again eagerly (the hooks that fired
before it fire again), and every later call with that hook runs eagerly.

The port's kernel wrappers count their calls (`ops.kernels.KERNELS`,
`.launches`): a call that captures counts those of its eager first
iteration and of the capture, and a replay counts none. How often a
replayed kernel ran is read from the profiler's kernel events.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import numbers
from typing import Callable, NamedTuple

import torch
from torch import nn
from torch.nn.modules import module as _module

from gan_discovery_pso_tpu_torch.core import profiling
from gan_discovery_pso_tpu_torch.core.config import PsoConfig
from gan_discovery_pso_tpu_torch.core.profiling import span
from gan_discovery_pso_tpu_torch.models.resnet import folds_in_force
from gan_discovery_pso_tpu_torch.pso.swarm import (
    PsoHistory,
    SwarmState,
    history_row,
    optimize,
    pso_iteration,
)

# the spans at whose entry a captured iteration starts its next graph
SEGMENTS = frozenset({"fitness.generator", "fitness.rescale", "fitness.assessor",
                      "fitness.objective", "pso.update", "pso.history"})


class HookReturned(Exception):
    """A forward hook returned a value in a graphed call; args[0] is its id."""


class IterationGraphs:
    """One runner's captured iteration (see the module), for a runner on
    `device` whose forwards run the models cast to `dtype` (None: as they
    are)."""

    def __init__(self, hp: PsoConfig, device: torch.device, dtype: torch.dtype | None):
        self.hp = hp
        self.device, self.dtype = device, dtype
        self._captured: _Captured | None = None
        self._returning: set = set()  # the ids of hooks that returned a value

    def optimize(self, make_fitness: Callable[[dict], Callable], closed: dict,
                 init_state: SwarmState, r1: torch.Tensor, r2: torch.Tensor,
                 models: tuple) -> tuple:
        """`optimize(make_fitness(closed), hp, init_state, r1, r2)`'s answer,
        replayed from the graphs where they apply. `closed` holds what the
        fitness closes over and a call makes anew (tensors or numbers):
        `make_fitness` may only keep them, since the graphs' copies are
        filled for each call after it ran. `models` are the modules whose
        forwards the fitness calls."""
        if self._applies(models):
            try:
                return self._run(make_fitness, closed, init_state, r1, r2, models)
            except HookReturned as e:
                self._returning.add(e.args[0])
        return optimize(make_fitness(closed), self.hp, init_state, r1, r2)

    def _applies(self, models: tuple) -> bool:
        """On the card with the models as they are (fp32 parity or TF32; the
        bf16 copies are made anew each call by `cast_model`, so they would
        capture every call), and no hook that a graph cannot honour."""
        if self.device.type != "cuda" or self.dtype is not None or self.hp.n_iterations == 0:
            return False
        if _module._global_forward_hooks or _module._global_forward_pre_hooks:
            return False
        for model in models:
            if not self._returning.isdisjoint(model._forward_hooks):
                return False
            for m in model.modules():
                if m._forward_pre_hooks or (m is not model and m._forward_hooks):
                    return False
        return True

    def _run(self, make_fitness, closed, init_state, r1, r2, models) -> tuple:
        key = _key(models, closed, init_state, r1, r2)
        captured, first = self._captured, 0
        if captured is None or captured.key != key:
            self._captured = None  # the old graphs' pool goes before the new one is made
            captured = _Captured(key, self.hp, make_fitness, closed, init_state, r1, r2,
                                 models)
            self._captured, first = captured, 1
        else:
            captured.load(closed, init_state, r1, r2)
        for _ in range(first, self.hp.n_iterations):
            captured.replay()
        with span("pso.stack"):
            final, history = captured.static.results()
        return final, history, init_state


def _key(models, closed: dict, init_state: SwarmState, r1, r2) -> tuple:
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return (
        tuple((t.shape, t.dtype, t.device) for t in (*init_state, r1, r2)),
        tuple((k, v.shape, v.dtype) if torch.is_tensor(v) else (k, type(v))
              for k, v in closed.items()),
        tuple(map(id, models)),
        tuple(t.data_ptr() for m in models for t in itertools.chain(m.parameters(),
                                                                    m.buffers())),
        tuple(m.training for model in models for m in model.modules()),
        tuple(map(id, folds_in_force())),
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark),
    )


def _static_like(v, device: torch.device) -> torch.Tensor:
    if torch.is_tensor(v):
        return torch.empty(v.shape, dtype=v.dtype, device=device)
    dtype = torch.long if isinstance(v, numbers.Integral) else torch.float32
    return torch.empty((), dtype=dtype, device=device)


class _Static:
    """The buffers that a graphed iteration reads and writes, and the
    iteration on them (`iterate`): the eager loop's code, with row t of the
    draws and of the history picked by the counter `t` on the device."""

    def __init__(self, hp: PsoConfig, make_fitness: Callable[[dict], Callable], closed: dict,
                 init_state: SwarmState, r1: torch.Tensor, r2: torch.Tensor):
        self.hp = hp
        device = r1.device
        self.state = SwarmState(*(_static_like(x, device) for x in init_state))
        self.r1, self.r2 = _static_like(r1, device), _static_like(r2, device)
        self.t = torch.zeros(1, dtype=torch.long, device=device)
        b, n, d = init_state.positions.shape
        rows = (b, hp.n_iterations)
        pos, val = init_state.positions.dtype, init_state.p_best_val.dtype
        self.history = PsoHistory(
            torch.empty((*rows, n, d), dtype=pos, device=device),
            torch.empty((*rows, n, d), dtype=pos, device=device),
            torch.empty((*rows, n), dtype=val, device=device),
            *(torch.empty(rows, dtype=dt, device=device) for dt in (pos, val, val, torch.bool)))
        self.closed = {k: _static_like(v, device) for k, v in closed.items()}
        self.fitness = make_fitness(self.closed)

    def load(self, closed: dict, init_state: SwarmState, r1: torch.Tensor,
             r2: torch.Tensor) -> None:
        """A call's inputs into the buffers, the counter at 0."""
        for dst, src in zip(self.state, init_state):
            dst.copy_(src)
        self.r1.copy_(r1)
        self.r2.copy_(r2)
        for k, dst in self.closed.items():
            v = closed[k]
            dst.copy_(v) if torch.is_tensor(v) else dst.fill_(v)
        self.t.zero_()

    def iterate(self) -> None:
        """Iteration t: the state moves on in place, history row t is written
        and t goes up by one."""
        state, t = self.state, self.t
        with span("pso.fitness"):
            fitness = self.fitness(state.positions)
        with span("pso.update", device_time=True):
            new = pso_iteration(state, fitness, self.r1.index_select(0, t)[0],
                                self.r2.index_select(0, t)[0], self.hp)
        with span("pso.history", device_time=True):
            after, row = history_row(state, new, fitness)
            for dst, src in zip(state, after):
                dst.copy_(src)
            for dst, src in zip(self.history, row):
                dst.index_copy_(1, t, src.unsqueeze(1))
            t.add_(1)

    def results(self) -> tuple:
        """Copies of the final state and of the history."""
        return (SwarmState(*(x.clone() for x in self.state)),
                PsoHistory(*(h.clone() for h in self.history)))


class _Segment(NamedTuple):
    name: str  # the span it replays in
    device_time: bool
    graph: torch.cuda.CUDAGraph
    forwards: list  # (module, args, output) of each model forward in it, in order


def _call_hooks(module: nn.Module, args: tuple, out, hooks: dict) -> None:
    """`hooks` (a module's forward hooks) on copies of one forward's args
    and output, as the module's call calls them; HookReturned where one
    returns a value."""
    if not hooks:
        return
    args = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
    out = out.clone()
    for hook_id, hook in list(hooks.items()):
        if hook_id in module._forward_hooks_with_kwargs:
            got = hook(module, args, {}, out)
        else:
            got = hook(module, args, out)
        if got is not None:
            raise HookReturned(hook_id)


@contextlib.contextmanager
def _hooks_replaced(models: tuple, proxy: Callable):
    """Inside, `proxy(module, args, out, its hooks)` is each model's only
    forward hook."""
    saved = [m._forward_hooks for m in models]
    try:
        for m, hooks in zip(models, saved):
            m._forward_hooks = collections.OrderedDict()
            m.register_forward_hook(lambda mod, args, out, hooks=hooks:
                                    proxy(mod, args, out, hooks))
        yield
    finally:
        for m, hooks in zip(models, saved):
            m._forward_hooks = hooks


class _Cutter:
    """Consecutive graphs in one pool, the next begun at each span of
    SEGMENTS (the first takes the name of the first such span), with the
    model forwards met in each."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.segments: list = []
        self.name, self.device_time, self.forwards = None, False, []
        self.graph = self._begin()

    def _begin(self) -> torch.cuda.CUDAGraph:
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool)
        return graph

    def cut(self, name: str, device_time: bool) -> None:
        if name not in SEGMENTS:
            return
        if self.name is not None:
            self.end()
            self.graph = self._begin()
        self.name, self.device_time = name, device_time

    def forward(self, module, args, out, _hooks) -> None:
        self.forwards.append((module, args, out))

    def end(self) -> None:
        graph, self.graph = self.graph, None
        graph.capture_end()
        self.segments.append(_Segment(self.name, self.device_time, graph, self.forwards))
        self.forwards = []


class _Captured:
    """A capture: its key, its buffers, the folds its graphs read and the
    graphs of one iteration."""

    def __init__(self, key: tuple, hp: PsoConfig, make_fitness, closed: dict,
                 init_state: SwarmState, r1, r2, models: tuple):
        self.key = key
        self.static = _Static(hp, make_fitness, closed, init_state, r1, r2)
        self.static.load(closed, init_state, r1, r2)
        # the graphs read this call's folds; later calls copy theirs in
        self.folds = [t for pair in folds_in_force().values() for t in pair]
        device = r1.device
        main, side = torch.cuda.current_stream(device), torch.cuda.Stream(device)
        side.wait_stream(main)
        try:
            with torch.cuda.stream(side):
                with span("pso.iteration"), _hooks_replaced(models, _call_hooks):
                    self.static.iterate()
                torch.cuda.synchronize(device)
                with span("pso.capture"):
                    segments = _capture(self.static.iterate, models)
        finally:
            main.wait_stream(side)
        self.fitness = [s for s in segments if s.name.startswith("fitness.")]
        self.loop = [s for s in segments if not s.name.startswith("fitness.")]

    def load(self, closed: dict, init_state: SwarmState, r1, r2) -> None:
        self.static.load(closed, init_state, r1, r2)
        folds = [t for pair in folds_in_force().values() for t in pair]
        if folds:
            torch._foreach_copy_(self.folds, folds)

    def replay(self) -> None:
        with span("pso.iteration"), span("pso.replay"):
            with span("pso.fitness"):
                for segment in self.fitness:
                    _replay(segment)
            for segment in self.loop:
                _replay(segment)


def _capture(iterate: Callable[[], None], models: tuple) -> list:
    """One call of `iterate` captured as consecutive graphs (`_Cutter`)."""
    cutter = None
    try:
        with profiling.cutting(lambda name, dt: cutter.cut(name, dt)), \
                _hooks_replaced(models, lambda *a: cutter.forward(*a)):
            cutter = _Cutter()
            iterate()
            cutter.end()
    except Exception as e:
        if cutter is not None and cutter.graph is not None:
            with contextlib.suppress(Exception):
                cutter.graph.capture_end()
        raise RuntimeError(f"capturing a PSO iteration as CUDA graphs failed: {e}") from e
    return cutter.segments


def _replay(segment: _Segment) -> None:
    with span(segment.name, segment.device_time):
        segment.graph.replay()
        for module, args, out in segment.forwards:
            _call_hooks(module, args, out, module._forward_hooks)
