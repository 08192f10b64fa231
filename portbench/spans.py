"""The program's spans (``item_alignment_torch.engine.observability``) set
against the device trace: two more profiled passes over a cell's
``trace_steps``, run once in a traced run, read by ``metrics/module_ms.py``,
``stage_ms.py``, ``dispatch_ms.py`` and ``idle_ms.py``.

- The spanned pass records the device's operations only, as
  ``idle_share`` is read, with the spans on: each entry span's host ms
  with the host not slowed by op recording, and each device idle gap put
  down to the entry phase open on the host at its middle (the rule of
  ``trace.Trace.idle_gaps``).
- The attributed pass records host and device activity with the spans on,
  so the profiler also records their ``ia.*`` ranges.  A device operation
  is charged to the innermost module span open when the host launched it
  (``MODULES``, which code shared by every model family opens, and the
  cell's family's ``SPANS``); one launched by a backward node, to the span
  open when that node's forward operation ran (the profiler's sequence
  numbers link the two).  The ranges' own device-side annotations are left
  out.

A step is the job's unit of work (``job.unit``), counted by the job's
step span (``job.STEP_SPAN``): a train step (``step``), a request in
scoring (``eval``), a round in mining (``build_cache``).  Each traced run
prints a table of the spans on standard error.

A job's ``traced()`` runs the passes and keeps their readings in its
record under ``spans``; ``of(rec)`` returns them.  Where the program has
no spans (a commit before them) there are no readings, and every reader
leaves its metric out.
"""

from __future__ import annotations

import statistics
import sys
from collections import defaultdict
from typing import (Callable, Dict, Iterable, List, NamedTuple, Optional,
                    Tuple)

import torch

from portbench.trace import Trace, group_of

# the module spans of the code every family shares: the attention entry,
# LayerNorm, dropout, the products' casts and the optimizer
MODULES = ("attention", "layernorm", "dropout", "cast", "optim")
ENTRY = ("step", "stage", "forward", "backward", "optim", "eval", "fetch",
         "build_cache", "encode")
RANGE = "ia."  # the prefix of the spans' profiler ranges
RUNTIME = "cu"  # the prefix of the CUDA runtime's and driver's calls


class Host(NamedTuple):
    """A host range of the profiler (an operation or a span's range), ns."""
    start: int
    end: int
    thread: int
    name: str
    corr: int        # a runtime call's: that of the operation it launched
    seq: int         # its autograd sequence number, -1 for none
    fwd_thread: int  # for a backward node: the thread of its forward op


class Device(NamedTuple):
    start: int
    end: int
    name: str
    corr: int  # the correlation id of the runtime call that launched it


def split(events) -> "tuple[List[Host], List[Device]]":
    """The host ranges and device operations of a profile's events
    (``_KinetoEvent``s), without the spans' device-side annotations."""
    from torch.autograd import DeviceType

    host, device = [], []
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            host.append(Host(start, end, e.start_thread_id(), e.name(),
                             e.correlation_id(), e.sequence_nr(),
                             e.fwd_thread_id()))
        elif not e.name().startswith(RANGE):
            device.append(Device(start, end, e.name(), e.correlation_id()))
    return host, device


def innermost(ranges: Iterable, points: List[int]) -> List[Optional[str]]:
    """For each point, the label of the innermost of ``ranges`` ``(start,
    end, label)`` that holds it, or None; the ranges nest properly."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out: List[Optional[str]] = [None] * len(points)
    stack: list = []
    i = 0
    for j in sorted(range(len(points)), key=points.__getitem__):
        t = points[j]
        while i < len(ranges) and ranges[i][0] <= t:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[j] = stack[-1][2]
    return out


def charge(host: List[Host], device: List[Device],
           modules: Tuple[str, ...] = MODULES) -> List[Optional[str]]:
    """The module span (of ``modules``) each device operation is charged
    to, or None.  An operation launched in the forward goes to the module range
    open on the host when the runtime's call launched it; one launched in
    a backward node, to the range open when the forward operation of the
    same thread and sequence number started (its last such operation: the
    one that made the node)."""
    by_thread: Dict[int, List[Host]] = defaultdict(list)
    for h in host:
        by_thread[h.thread].append(h)

    def spanned(thread: int, points: List[int]) -> List[Optional[str]]:
        return innermost(((h.start, h.end, h.name[len(RANGE):])
                          for h in by_thread[thread]
                          if h.name[len(RANGE):] in modules
                          and h.name.startswith(RANGE)), points)

    forward: Dict[tuple, int] = {}  # (thread, seq) -> the op's start
    for h in host:
        if h.seq >= 0 and h.fwd_thread <= 0:
            key = (h.thread, h.seq)
            forward[key] = max(forward.get(key, h.start), h.start)
    keys = list(forward)
    fwd_label: Dict[tuple, Optional[str]] = {}
    for thread in {k[0] for k in keys}:
        mine = [k for k in keys if k[0] == thread]
        for k, label in zip(mine, spanned(thread, [forward[k] for k in mine])):
            fwd_label[k] = label

    # the runtime's call shares the operation's id; an operator's id may be
    # the same number, so only the runtime's calls are looked up
    calls = {h.corr: h for h in host if h.name.startswith(RUNTIME)}
    launched = [calls.get(d.corr) for d in device]
    out: List[Optional[str]] = [None] * len(device)
    for thread, hosts in by_thread.items():
        idx = [i for i, h in enumerate(launched)
               if h is not None and h.thread == thread]
        points = [launched[i].start for i in idx]
        nodes = innermost(((h.start, h.end, (h.fwd_thread, h.seq))
                           for h in hosts
                           if h.seq >= 0 and h.fwd_thread > 0), points)
        direct = spanned(thread, points)
        for i, node, label in zip(idx, nodes, direct):
            out[i] = fwd_label.get(node) if node is not None else label
    return out


def attribute(host: List[Host], device: List[Device],
              modules: Tuple[str, ...] = MODULES) -> Dict[str, Dict]:
    """Device ns by module span (of ``modules``): all of each span's
    operations (``all``), and those of the ``rest`` group (``rest``), with
    the rest charged to none under ``unspanned``."""
    total: Dict[str, float] = defaultdict(float)
    rest: Dict[str, float] = defaultdict(float)
    unspanned: Dict[str, float] = defaultdict(float)
    for d, label in zip(device, charge(host, device, modules)):
        ns = d.end - d.start
        is_rest = group_of(d.name) == "rest"
        if label is not None:
            total[label] += ns
            if is_rest:
                rest[label] += ns
        elif is_rest:
            total["unspanned"] += ns
            rest["unspanned"] += ns
            unspanned[d.name[:60]] += ns
    return {"all": dict(total), "rest": dict(rest),
            "unspanned": dict(unspanned)}


def phase_trace(spans, device: List[Device], t0: int, t1: int) -> Trace:
    """The window ``[t0, t1]`` as a ``Trace`` in us from ``t0``, its host
    ranges the entry spans (``ENTRY``): its ``idle_gaps`` put each gap down
    to the innermost entry span open on the host at the gap's middle
    (``no host range`` where none is)."""
    def us(t):
        return (t - t0) / 1e3

    return Trace(0.0, us(t1), [(us(d.start), us(d.end), d.name)
                               for d in device],
                 [(us(s.start_ns), us(s.end_ns), s.name) for s in spans
                  if s.name in ENTRY])


def idle_by_phase(trace: Trace) -> Dict[str, float]:
    """Device idle seconds of ``trace`` by the phase each gap is put down
    to."""
    out: Dict[str, float] = defaultdict(float)
    for name, seconds in trace.idle_gaps(n=len(trace.device) + 1):
        out[name] += seconds
    return dict(out)


def _profile(fn: Callable[[], object], host: bool):
    """``fn()`` under the profiler with the spans on; the spans, the
    profile's events and the window's ends on the spans' clock."""
    from torch.profiler import ProfilerActivity, profile

    from item_alignment_torch.engine.observability import clock_ns, tracing

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = ([ProfilerActivity.CPU] if host or not cuda else []) \
        + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities):
        pass  # the tracer's one-time start, outside the window
    sync()
    with tracing() as record, profile(activities=activities) as prof:
        t0 = clock_ns()
        fn()
        sync()
        t1 = clock_ns()
    return record.spans, prof.profiler.kineto_results.events(), t0, t1


def _host_ns(spans, name: str) -> float:
    return float(sum(s.end_ns - s.start_ns for s in spans if s.name == name))


def passes(job, rec: Dict) -> Optional[Dict]:
    """Run the spanned and the attributed pass on ``job`` (``job.unit`` of
    its ``trace_steps``) and read them: ms a step of each entry span on the
    host, of each module span and of ``unspanned`` on the device, and of
    idle by phase; ``rec`` is the traced run's record so far, for the
    table.  None where the program has no spans."""
    from item_alignment_torch.engine import observability

    if not hasattr(observability, "tracing"):
        return None
    modules = tuple(dict.fromkeys(MODULES + tuple(job.family.SPANS)))
    units = job.work["trace_steps"]

    def work():
        job.unit(units)

    spans, events, t0, t1 = _profile(work, host=False)
    steps = len([s for s in spans if s.name == job.STEP_SPAN])
    host, device = split(events)
    out = {"kind": job.work["job"], "steps": steps,
           "spanned_ranges": sum(h.name.startswith(RANGE) for h in host),
           "spanned_s": (t1 - t0) / 1e9,
           "host_ms": {n: _host_ns(spans, n) / 1e6 / steps for n in ENTRY},
           "calls": {n: len([s for s in spans if s.name == n]) / steps
                     for n in ENTRY + modules},
           "busy_ms": None, "idle_ms": None, "module_ms": None}
    if device:
        trace = phase_trace(spans, device, t0, t1)
        out["busy_ms"] = trace.busy_s * 1e3 / steps
        out["idle_ms"] = {k: v * 1e3 / steps
                          for k, v in idle_by_phase(trace).items()}
    spans, events, t0, t1 = _profile(work, host=True)
    host, device = split(events)
    out["attributed_s"] = (t1 - t0) / 1e9
    out["clock_us"] = clock_agreement(spans, host)
    calls = {h.corr for h in host if h.name.startswith(RUNTIME)}
    out["linked"] = sum(d.end - d.start for d in device if d.corr in calls) \
        / max(1, sum(d.end - d.start for d in device))
    if device:
        ns = attribute(host, device, modules)
        out["module_ms"] = {k: v / 1e6 / steps for k, v in ns["all"].items()}
        out["rest_ms"] = {k: v / 1e6 / steps for k, v in ns["rest"].items()}
        out["unspanned_ms"] = sorted(
            ((v / 1e6 / steps, k) for k, v in ns["unspanned"].items()),
            reverse=True)[:8]
    table(out, rec)
    return out


def clock_agreement(spans, host: List[Host]) -> Optional[List[float]]:
    """The median and the largest gap, in us, between the spans' own ends
    and their ``ia.*`` ranges', matched in order by name."""
    ranges: Dict[str, List[Host]] = defaultdict(list)
    for h in host:
        if h.name.startswith(RANGE):
            ranges[h.name[len(RANGE):]].append(h)
    gaps = []
    for name, hs in ranges.items():
        mine = sorted((s for s in spans if s.name == name),
                      key=lambda s: s.start_ns)
        hs = sorted(hs, key=lambda h: h.start)
        if len(mine) != len(hs):
            continue
        for s, h in zip(mine, hs):
            gaps += [abs(s.start_ns - h.start) / 1e3,
                     abs(s.end_ns - h.end) / 1e3]
    return [statistics.median(gaps), max(gaps)] if gaps else None


def table(out: Dict, rec: Dict) -> None:
    """The spans of the passes, one line each, on standard error."""
    steps = out["steps"]
    base = rec.get("trace")
    line = [f"spans ({out['kind']}, {steps} steps a pass): a step takes "
            f"{1e3 * out['spanned_s'] / steps:.2f} ms spanned, "
            f"{1e3 * out['attributed_s'] / steps:.2f} ms attributed"]
    if base is not None and rec.get("steps"):
        line.append(f", {1e3 * base.window_s / rec['steps']:.2f} ms in the "
                    f"device-only pass")
    line.append(f"; clock agreement (median, max us) {out['clock_us']}; "
                f"{out['spanned_ranges']} ranges in the spanned pass; "
                f"device time linked to a launch {100 * out['linked']:.1f}%")
    rows = ["".join(line),
            f"{'span':<12}{'calls':>8}{'host ms':>10}{'device ms':>11}"
            f"{'rest ms':>9}{'idle ms':>9}"]
    module = out["module_ms"] or {}
    rest = out.get("rest_ms") or {}
    idle = out["idle_ms"] or {}
    for name in dict.fromkeys(tuple(out["calls"]) + ("unspanned",)):
        calls = out["calls"].get(name, 0.0)
        if not calls and name not in module:
            continue
        host_ms = out["host_ms"].get(name)
        cells = [f"{calls:8.1f}",
                 f"{host_ms:10.2f}" if host_ms is not None else f"{'':>10}",
                 f"{module[name]:11.2f}" if name in module else f"{'':>11}",
                 f"{rest[name]:9.2f}" if name in rest else f"{'':>9}",
                 f"{idle[name]:9.2f}" if name in idle else f"{'':>9}"]
        rows.append(f"{name:<12}" + "".join(cells))
    if rest and base is not None and rec.get("steps"):
        rest_ms = 1e3 * base.group_s().get("rest", 0.0) / rec["steps"]
        rows.append(f"rest by span {sum(rest.values()):.2f} ms a step, "
                    f"rest_ms {rest_ms:.2f}; busy {out['busy_ms']:.2f} ms; "
                    f"idle outside the phases "
                    f"{idle.get('no host range', 0.0):.2f} ms")
    rows += [f"  unspanned {ms:8.3f} ms  {name}"
             for ms, name in out.get("unspanned_ms", [])]
    print("\n".join(rows), file=sys.stderr, flush=True)


def of(rec: Dict) -> Optional[Dict]:
    """The spans' readings of the traced run whose record is ``rec``
    (``passes``, which the job's ``traced()`` ran); None where the
    program has no spans."""
    return rec.get("spans")
