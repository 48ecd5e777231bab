"""The traced stretch of a `--trace 1` run, read from `torch.profiler`.

After the measured window, the profiler records the card's activity alone
(kernels, copies, sets and the host's CUDA API calls; recording the host's
ATen operations too doubled the host's time a call and made the device look
idle) over one lead call, a synchronisation, `trace_calls` calls and a
second synchronisation. A session loses its first device events as a rule,
hence the lead call. The stretch runs from the end of the first
`cudaDeviceSynchronize` to the start of the second; every number below is
taken inside it:

- busy: the union of the device intervals (kernels, copies, sets) on the
  card, and idle = the stretch minus busy;
- launches: the host's kernel-launch API events;
- device µs and events of each device operation, by name;
- the longest idle gaps of the device, each named by the host's CUDA API
  call that spans the gap's middle (none: the host was in Python or ATen
  between calls) and the device operation that ended the gap.

Nothing is written to disk.
"""

from __future__ import annotations

import torch

SYNC = "cudaDeviceSynchronize"
TOP = 10


def record(entry, draws, k0: int, n_calls: int) -> tuple:
    """(the profiler's events, the host outputs of the traced calls)."""
    from torch.profiler import ProfilerActivity, profile

    outs = []
    activities = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [
        ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        entry.call(draws.call(k0))
        _sync()
        for i in range(n_calls):
            outs.append(entry.call(draws.call(k0 + 1 + i)))
        _sync()
    return prof.events(), outs


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, n_calls: int) -> dict | None:
    """The stretch's numbers (times in µs), or None when it has no two
    synchronisations or holds no device event."""
    from torch.autograd import DeviceType

    cpu, dev = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append(e)
        else:
            cpu.append(e)
    syncs = sorted((e for e in cpu if e.name == SYNC), key=lambda e: e.time_range.start)
    if len(syncs) < 2:
        return None
    lo, hi = syncs[0].time_range.end, syncs[-1].time_range.start
    inside = [(max(e.time_range.start, lo), min(e.time_range.end, hi), e.name) for e in dev
              if e.time_range.end > lo and e.time_range.start < hi]
    if not inside:
        return None
    per_name: dict = {}
    for s, e, name in inside:
        total, count = per_name.get(name, (0.0, 0))
        per_name[name] = (total + (e - s), count + 1)
    busy = _merge([(s, e) for s, e, _ in inside])
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    starts = sorted((s, name) for s, _, name in inside)
    return {
        "window_us": hi - lo,
        "busy_us": sum(e - s for s, e in busy),
        "calls": n_calls,
        "launches": sum(1 for e in cpu if "LaunchKernel" in e.name
                        and lo <= e.time_range.start < hi),
        "per_name": per_name,
        "gaps": [(_host_at(cpu, (s + e) / 2), _next_op(starts, e), e - s)
                 for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]],
    }


def _host_at(cpu: list, t: float) -> str:
    spanning = [e for e in cpu if e.time_range.start <= t < e.time_range.end]
    if not spanning:
        return "Python or ATen"
    return max(spanning, key=lambda e: e.time_range.start).name


def _next_op(starts: list, t: float) -> str:
    for s, name in starts:
        if s >= t:
            return name
    return "end of stretch"


def breakdown(summary: dict) -> dict:
    """The result line's `breakdown`: the device operations that took most
    time and the longest idle gaps, each in seconds."""
    ops = sorted(summary["per_name"].items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "device_ops": [[name[:160], total / 1e6] for name, (total, _) in ops],
        "idle_gaps": [[f"host in {host[:80]}; then {nxt[:60]}", us / 1e6]
                      for host, nxt, us in summary["gaps"]],
    }


def kernel_us(summary: dict, names: tuple) -> tuple[float, int]:
    """(device µs, events) of the device operations whose name holds one of
    `names`."""
    hits = [v for k, v in summary["per_name"].items() if any(n in k for n in names)]
    return sum(t for t, _ in hits), sum(c for _, c in hits)
