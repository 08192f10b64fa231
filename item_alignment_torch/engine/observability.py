"""Observability: metric writers, step timing and the profiler hook.

Port of ``item_alignment_tpu/engine/observability.py``: the reference's CSV
results writer and scalar stream (``finetune_bert.py:36-65``), per-step wall
time, and a trace of a region.  ``profile_trace`` records a
``torch.profiler`` trace (CPU, and CUDA when the card is there) and writes
it as a Chrome trace, ``trace.json``, in the given directory.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import time
from typing import Any, Iterable, List, Optional

import torch

from item_alignment_torch.utils import logger


class EvalWriter:
    """CSV results writer: one row per evaluation with a fixed header,
    flushed on every write."""

    def __init__(self, path: str, fieldnames: Iterable[str]):
        self.path = path
        self.fieldnames = list(fieldnames)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        exists = os.path.exists(path)
        self._fh = open(path, "a", newline="", encoding="utf-8")
        self._writer = csv.DictWriter(self._fh, fieldnames=self.fieldnames)
        if not exists:
            self._writer.writeheader()
            self._fh.flush()

    def write(self, **row: Any) -> None:
        self._writer.writerow({k: row.get(k, "") for k in self.fieldnames})
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class ScalarLogger:
    """Append-only JSONL scalar stream: one line per (tag, step, value) with
    the wall time."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._fh.write(json.dumps({"tag": tag, "value": float(value),
                                   "step": int(step),
                                   "time": time.time()}) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class StepTimer:
    """Rolling per-step timing; gives steps/s and ms/step."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def ms_per_step(self) -> float:
        return 1000.0 * sum(self._times) / len(self._times) if self._times else 0.0

    @property
    def steps_per_sec(self) -> float:
        return 1000.0 / self.ms_per_step if self.ms_per_step else 0.0


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]):
    """Record a ``torch.profiler`` trace of the block into
    ``trace_dir/trace.json``; does nothing when ``trace_dir`` is None."""
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info(f"profiler trace written to {path}")


def format_time(seconds: float) -> str:
    """hh:mm:ss."""
    seconds = int(round(seconds))
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    return f"{h:d}:{m:02d}:{s:02d}"
