"""chip_smoke.py's standalone kernel timing: the device µs come from the
profiler's kernel events, and from a CUDA graph replay where every
profiler session lost its kernel events. The profiler and the graph run
only on the card; here both are stood in for, to hold the choice
between them."""

import importlib.util
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
CALLS = 80


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _session(kept: int, lost: list[int]) -> dict:
    return {"calls": CALLS, "launch_api": CALLS, "kept": kept, "calls_without_kernel": lost}


@pytest.mark.parametrize("sessions, source, device_us", [
    # every session keeps no kernel event: the graph replay's µs
    ([_session(0, list(range(CALLS)))] * 5, "graph replay", 2.5),
    # the first session loses all, the second its first 11 calls
    ([_session(0, list(range(CALLS))), _session(CALLS - 11, list(range(11)))],
     "profiler", 2.0),
])
def test_time_shape_reads_the_profiler_else_the_graph_replay(monkeypatch, sessions, source,
                                                             device_us):
    cs = _chip_smoke()
    made = []

    def profile_session(fn, kernel_names, launches):
        made.append(sessions[len(made)])
        return [2.0] * min(made[-1]["kept"], launches), dict(made[-1])

    monkeypatch.setattr(cs, "profile_session", profile_session)
    monkeypatch.setattr(cs, "graph_us", lambda fn: 2.5)
    monkeypatch.setattr(cs, "in_turns", lambda kernel, plain: (0.05, 0.2))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    rec = cs.time_shape(lambda: None, lambda: None, [()], ("k",), (1, 16, 100),
                        (1e-3, "bytes"))
    assert len(made) == len(sessions) <= cs.PROFILER_SESSIONS
    assert rec["device_us_from"] == source and rec["device_us"] == device_us
    assert rec["graph_replay_us"] == 2.5
    assert rec["share_of_bound"] == pytest.approx(1.0 / device_us)
    assert rec["profiled_launches"] == (cs.PROFILED_LAUNCHES if source == "profiler" else 0)
    assert rec["profiler_sessions"] == sessions


def test_device_us_fails_a_session_that_lost_a_later_call(monkeypatch):
    """Only a leading run of a session's calls may lose its kernel events."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "profile_session",
                        lambda fn, kernel_names, launches: ([2.0] * 79, _session(79, [40])))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    with pytest.raises(AssertionError, match="not a loss of its first calls"):
        cs.device_us(lambda: None, ("k",))
