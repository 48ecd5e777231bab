"""Profiling: spans at the program's layer boundaries and device traces
(counterpart of `gan_discovery_pso_tpu/core/profiling.py`).

- `span(name, device_time=False)`: a context manager around one layer of
  the hot path (`pso/runner.py`, `pso/swarm.py optimize`,
  `pso/fitness.py`). It records only while a `torch.profiler` session
  records in this process, and never while `torch.compile` or
  `torch.export` traces; otherwise it returns one shared no-op context,
  and costs the read of the profiler's Python flag. A recorded span keeps
  its name, its id, its parent's id, the id of its root (the runner call
  it belongs to), and its host start and end on the profiler's clock
  (`time.time_ns()`: an event's µs in `prof.events()` plus
  `prof.profiler.kineto_results.trace_start_ns()`). With `device_time`,
  where the process has initialised CUDA, it also records a pair of
  timing events on the current stream (no kernel launch). It opens a
  fast `RecordFunction` range, which only a session with CPU activity
  records, so a CPU+CUDA session's timeline shows the layers over the
  kernels. The last `SPAN_BUFFER` spans are kept.
- `spans()`: the kept spans as dicts; `clear_spans()` empties the buffer.
- `cutting(cut)`: inside, every `span(name, device_time)` records nothing
  and calls `cut(name, device_time)` at its entry instead. `pso/graphs.py`
  cuts a captured PSO iteration there into one CUDA graph per layer.
- `trace(log_dir)`: a `torch.profiler` session over the enclosed section,
  CPU and CUDA activities (CUDA where the host has it), written as a
  Chrome/TensorBoard trace (`*.pt.trace.json`) into `log_dir`.

Spans nest on one stack: open them on the thread that runs the call.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_BUFFER = 200_000

_OFF = contextlib.nullcontext()
_open: list = []  # the spans open now, innermost last
_kept: collections.deque = collections.deque()
_free_events: list = []  # timing events whose readings were taken
_ids = itertools.count(1)
_streams: dict = {}  # the CUDA streams met, by (id, device index, device type)
_cut = None  # inside `cutting`: called at each span's entry in place of a record


def span(name: str, device_time: bool = False):
    """`with span("pso.update", device_time=True): ...` — a recorded span
    while a profiler session records, else the shared no-op context (see
    the module)."""
    if _cut is not None:
        _cut(name, device_time)
        return _OFF
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return _OFF
    return _Span(name, device_time)


@contextlib.contextmanager
def cutting(cut):
    """Inside, `span(name, device_time)` calls `cut(name, device_time)` at
    its entry and records nothing."""
    global _cut
    saved, _cut = _cut, cut
    try:
        yield
    finally:
        _cut = saved


def _event_pair() -> tuple:
    if len(_free_events) < 2:
        return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    return _free_events.pop(), _free_events.pop()


def _current_stream() -> torch.cuda.Stream:
    """`torch.cuda.current_stream()` without building a new `Stream` each
    call (about 7 µs of a shared H100 host's time, twice a span)."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return stream


class _Span:
    __slots__ = ("name", "id", "parent", "call", "start_ns", "end_ns", "events", "device_us",
                 "_range")

    def __init__(self, name: str, device_time: bool):
        self.name = name
        self.events = () if device_time and torch.cuda.is_initialized() else None
        self.device_us = None

    def __enter__(self):
        self.id = next(_ids)
        if _open:
            self.parent, self.call = _open[-1].id, _open[-1].call
        else:
            self.parent, self.call = None, self.id
        _open.append(self)
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        if self.events is not None:
            self.events = _event_pair()
            self.events[0].record(_current_stream())
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(_current_stream())
        self.end_ns = time.time_ns()
        self._range.__exit__(*exc)
        self._range = None
        _open.pop()
        if len(_kept) >= SPAN_BUFFER:
            _release(_kept.popleft())
        _kept.append(self)
        return False


def _release(s: _Span) -> None:
    if s.events:
        _free_events.extend(s.events)
    s.events = None


def spans() -> list:
    """The kept spans in the order they opened, each a dict: name, id,
    parent (None for a root), call (the root's id), start_ns and end_ns
    (the profiler's clock), host_ns, device_us (None without
    `device_time` or off the card). Waits for the card to reach each
    timed span's end first."""
    kept = sorted(_kept, key=lambda s: s.id)
    for s in kept:
        if s.events:
            start, end = s.events
            end.synchronize()
            s.device_us = 1e3 * start.elapsed_time(end)
            _release(s)
    return [{"name": s.name, "id": s.id, "parent": s.parent, "call": s.call,
             "start_ns": s.start_ns, "end_ns": s.end_ns, "host_ns": s.end_ns - s.start_ns,
             "device_us": s.device_us} for s in kept]


def clear_spans() -> None:
    """Empty the buffer (its timing events go back to the pool)."""
    for s in _kept:
        _release(s)
    _kept.clear()


@contextlib.contextmanager
def trace(log_dir: str | Path, enabled: bool = True):
    """Profile the enclosed section into `log_dir` (view with TensorBoard's
    profiler plugin or chrome://tracing); yields the profiler, or None when
    not enabled."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof
