"""Observability: metric writers, spans and the profiler hook.

Port of ``item_alignment_tpu/engine/observability.py``: the reference's CSV
results writer and scalar stream (``finetune_bert.py:36-65``), and a trace
of a region.  ``profile_trace`` records a ``torch.profiler`` trace (CPU,
and CUDA when the card is there) and writes it as a Chrome trace,
``trace.json``, in the given directory.

Spans (the port's own; the JAX package has none): ``span(name, index)``
marks where the program does a phase of its work (a step's ``forward``, a
``layernorm``).  Off, which is the default, it returns one shared no-op
context: no clock read, no allocation, no profiler call.  Inside
``tracing()`` each span is kept in memory (``SpanRecord``) with its
parent, its start and end and the step or request it belongs to, and,
while a profiler runs, also opens ``torch.profiler.record_function
("ia.<name>")``, so the ranges show in the profiler's trace.  A span reads
the profiler's own clock (ns since the Unix epoch, to which the profiler
converts its host and device timestamps), so a device gap can be set
against the span open on the host at that moment.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Iterable, List, Optional

import torch
from torch.profiler import record_function

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


# the clock spans read: the profiler's, which stamps host and device events
# in ns since the Unix epoch (tests/test_torch_spans.py holds spans to its
# ranges)
clock_ns = time.time_ns


@dataclass(eq=False)
class Span:
    """One span: ``parent`` is the span open around it on the same thread
    (None at the top); ``start_ns`` and ``end_ns`` are on the profiler's
    clock (``end_ns`` is 0 while it is open); ``index`` is the step or
    request it belongs to, given or its parent's."""
    name: str
    parent: Optional["Span"]
    start_ns: int
    end_ns: int
    index: Optional[int]


class SpanRecord:
    """The spans of one ``tracing()`` block, in the order they opened."""

    def __init__(self):
        self.spans: List[Span] = []
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


class _OpenSpan:
    __slots__ = ("record", "name", "index", "span", "range")

    def __init__(self, record: SpanRecord, name: str, index: Optional[int]):
        self.record, self.name, self.index = record, name, index

    def __enter__(self) -> Span:
        stack = self.record._stack()
        parent = stack[-1] if stack else None
        index = self.index
        if index is None and parent is not None:
            index = parent.index
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = record_function("ia." + self.name)
            self.range.__enter__()
        self.span = Span(self.name, parent, clock_ns(), 0, index)
        self.record.spans.append(self.span)
        stack.append(self.span)
        return self.span

    def __exit__(self, *exc) -> bool:
        self.span.end_ns = clock_ns()
        self.record._stack().pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


_record: Optional[SpanRecord] = None
_NO_SPAN = contextlib.nullcontext()


def span(name: str, index: Optional[int] = None):
    """A context that marks the program's phase ``name`` (of step or
    request ``index``) inside ``tracing()``, and does nothing outside
    it."""
    if _record is None:
        return _NO_SPAN
    return _OpenSpan(_record, name, index)


@contextlib.contextmanager
def tracing():
    """Turn spans on for the block and yield their ``SpanRecord``; inside
    another ``tracing()`` block, the outer one's."""
    global _record
    if _record is not None:
        yield _record
        return
    _record = SpanRecord()
    try:
        yield _record
    finally:
        _record = None


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]):
    """Record a ``torch.profiler`` trace of the block, with its spans'
    ``ia.*`` ranges, into ``trace_dir/trace.json``; does nothing when
    ``trace_dir`` is None."""
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with tracing(), torch.profiler.profile(activities=activities) as prof:
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
