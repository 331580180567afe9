"""Observability: step timers, metrics logging (JSONL and TensorBoard),
profiler traces and the UI progress file; the port of
``animate3d_tpu/utils/logging.py`` (its ``WandbLogger`` is not ported: it
publishes to an outside service, and ``use_wandb`` raises in the trainer)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import torch


class StepTimer:
    """``with timer:`` around a step; ``.last`` holds its seconds. On a CUDA
    ``device`` the exit synchronises it first, so the time is the device's
    work and not its enqueue."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.last = 0.0
        self.total = 0.0
        self.count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last = time.perf_counter() - self._t0
        self.total += self.last
        self.count += 1
        return False

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


class MetricsLogger:
    """Append-only JSONL metrics and a TensorBoard event file
    (``utils/tb_writer.py``) in ``tb_dir``: by default ``<dir of path>/tb``;
    ``tb_dir=""`` writes none."""

    def __init__(self, path: str, tb_dir: Optional[str] = None):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if tb_dir is None:
            tb_dir = os.path.join(os.path.dirname(path) or ".", "tb")
        self._tb = None
        if tb_dir:
            from animate3d_tpu_torch.utils.tb_writer import TBWriter

            self._tb = TBWriter(tb_dir)

    @property
    def tb_path(self) -> Optional[str]:
        return self._tb.path if self._tb is not None else None

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        """Append ``{"step": step, **metrics}`` as one line (numbers as
        floats, anything else as text) and the numbers as TB scalars."""
        rec = {"step": step}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.scalars(metrics, step)
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where there is
    a card) written as a chrome trace under ``log_dir`` when it is set;
    a no-op otherwise. Yields the profiler (None when off); its
    ``trace_path`` names the file once the block has ended."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


class ProgressWriter:
    """One-line progress file for UI front-ends (``launch.py --gradio``): the
    file is rewritten in place, not appended, so a poller reads one current
    line."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = None

    def write(self, msg: str) -> None:
        if self._f is None:
            self._f = open(self.path, "w")
        self._f.seek(0)
        self._f.truncate()
        self._f.write(msg)
        self._f.flush()

    def train_step(self, step: int, max_steps: int) -> None:
        self.write(f"Generation progress: {step / max(max_steps, 1) * 100:.2f}%")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
