"""Logging: stdout tee into the run dir, metric histories, notifier hook
(counterpart of `gan_discovery_pso_tpu/core/logging.py:38-188`, the parts
the stages use; `MetricsWriter.drop_rows_from` :102 for a resumed run).

Replaces the reference's `Logger` stdout/stderr tee
(reference src/utils/util_general.py:140-193) and its hard-coded webhook
(:75-78) with a pluggable, opt-in notifier.
"""

from __future__ import annotations

import csv
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Mapping

import numpy as np


def format_time(seconds: float) -> str:
    """Human-readable duration (reference src/utils/util_general.py:195-206)."""
    s = int(np.rint(seconds))
    if s < 60:
        return f"{s}s"
    if s < 60 * 60:
        return f"{s // 60}m {s % 60:02d}s"
    if s < 24 * 60 * 60:
        return f"{s // 3600}h {(s // 60) % 60:02d}m {s % 60:02d}s"
    return f"{s // 86400}d {(s // 3600) % 24:02d}h {(s // 60) % 60:02d}m"


class Tee:
    """Duplicate stdout/stderr into `log.txt` inside the run dir. Context
    manager."""

    def __init__(self, file_path: str | Path, mode: str = "w"):
        self.file = open(file_path, mode, buffering=1)
        self._stdout = None
        self._stderr = None

    def __enter__(self):
        self._stdout, self._stderr = sys.stdout, sys.stderr
        sys.stdout = _Fork(self._stdout, self.file)
        sys.stderr = _Fork(self._stderr, self.file)
        return self

    def __exit__(self, *exc):
        sys.stdout = self._stdout
        sys.stderr = self._stderr
        self.file.close()
        return False


class _Fork:
    def __init__(self, *sinks):
        self.sinks = sinks

    def write(self, data):
        for s in self.sinks:
            s.write(data)

    def flush(self):
        for s in self.sinks:
            s.flush()

    def isatty(self):
        return False


class MetricsWriter:
    """Append-only metric history with CSV + JSONL artifacts; one row per
    append(step, **metrics). The TensorBoard sink is optional: asked for
    and not importable, it is left out."""

    def __init__(self, out_dir: str | Path, name: str = "history",
                 tensorboard: bool = False, tb_dir: str | Path | None = None):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.name = name
        self._rows: list[dict] = []
        self._jsonl = open(self.out_dir / f"{name}.jsonl", "a", buffering=1)
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                root = Path(tb_dir) if tb_dir is not None else self.out_dir / "logs"
                self._tb = SummaryWriter(str(root / name))
            except ImportError:
                pass

    def drop_rows_from(self, step: int) -> None:
        """Rewrite the jsonl keeping only the rows with step < `step` (a
        resumed run re-runs the epochs from there), and seed the rows the
        close-time csv is built from with them, so that the csv covers the
        whole run, not only the resumed invocation."""
        path = self.out_dir / f"{self.name}.jsonl"
        self._jsonl.close()
        kept = []
        if path.exists():
            for line in open(path):
                try:
                    if int(json.loads(line).get("step", -1)) < step:
                        kept.append(line)
                except (ValueError, json.JSONDecodeError):
                    continue
        with open(path, "w") as f:
            f.writelines(kept)
        self._jsonl = open(path, "a", buffering=1)
        self._rows = [json.loads(line) for line in kept] + self._rows

    def append(self, step: int, **metrics) -> None:
        row = {"step": int(step)}
        for k, v in metrics.items():
            row[k] = float(np.asarray(v))
        self._rows.append(row)
        # strict JSON: nan/inf have no JSON literal, so they go out as null
        safe = {k: (v if not isinstance(v, float) or math.isfinite(v) else None)
                for k, v in row.items()}
        self._jsonl.write(json.dumps(safe, allow_nan=False) + "\n")
        if self._tb is not None:
            for k, v in row.items():
                if k != "step":
                    self._tb.add_scalar(k, v, global_step=row["step"])

    def add_image(self, tag: str, image, step: int) -> None:
        """One [C, H, W] image in [0, 1] to the TensorBoard sink (reference
        src/pso/util_pso.py:131-133); a no-op without one."""
        if self._tb is not None:
            self._tb.add_image(tag, np.asarray(image), global_step=int(step))

    def flush_csv(self) -> Path:
        path = self.out_dir / f"{self.name}.csv"
        keys = sorted({k for r in self._rows for k in r})
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self._rows)
        return path

    def close(self):
        self.flush_csv()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class Notifier:
    """Pluggable run-lifecycle notifier; default: print only."""

    def __init__(self, hook: Callable[[str, Mapping], None] | None = None):
        self.hook = hook
        self._t0 = time.time()

    def __call__(self, event: str, **payload) -> None:
        payload = {"elapsed": format_time(time.time() - self._t0), **payload}
        print(f"[notify] {event}: {payload}")
        if self.hook is not None:
            try:
                self.hook(event, payload)
            except Exception as e:  # a notification must never kill a run
                print(f"[notify] hook failed: {e!r}")
