"""A profiled window and what is read from it.

``profiled(fn)`` runs ``fn`` once under ``torch.profiler`` (no shapes, no
stacks; nothing written to disk) and ends with a synchronize.  The
``Trace`` it returns keeps the device operations of that window, and with
``host=True`` the host's ranges:

- ``window_s``: the window's length;
- ``busy_s``: the union of the device operations' intervals inside it
  (operations that overlap count once), so ``1 - busy_s / window_s`` is the
  share in which the device ran nothing;
- ``group_s``: device seconds by kernel-name group (``KERNEL_GROUPS``:
  substrings of a lower-cased kernel name; the rest is ``rest``; copies
  and fills are ``memory``);
- ``top_ops`` and ``idle_gaps``: the device operations that took the most
  time, and the longest gaps between them, each named by the innermost
  host range open at its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "portbench.window"
KERNEL_GROUPS = (
    ("attention", ("attn_", "flash_")),
    ("products", ("gemm", "xmma", "nvjet", "cutlass", "wgmma")),
)
MEMORY_OPS = ("memcpy", "memset")


def group_of(name: str) -> str:
    low = name.lower()
    if low.startswith(MEMORY_OPS):
        return "memory"
    for group, keys in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return group
    return "rest"


Interval = Tuple[float, float, str]  # start, end (us), name


@dataclass
class Trace:
    start_us: float
    end_us: float
    device: List[Interval]
    host: List[Interval] = field(default_factory=list)
    host_s: float = 0.0  # host clock over the window, synchronised

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def _merged(self) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for s, e, _ in sorted(self.device):
            s, e = max(s, self.start_us), min(e, self.end_us)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._merged()) / 1e6

    def group_s(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s, e, name in self.device:
            g = group_of(name)
            out[g] = out.get(g, 0.0) + (e - s) / 1e6
        return out

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = {}
        for s, e, name in self.device:
            total[name[:160]] = total.get(name[:160], 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: float, starts: List[float],
                 hosts: List[Interval]) -> str:
        i = bisect.bisect_right(starts, t)
        for s, e, name in reversed(hosts[max(0, i - 4000):i]):
            if e >= t and name != WINDOW:
                return name
        return "no host range"

    def idle_gaps(self, n: int = 10) -> List[List]:
        merged = self._merged()
        edges = [self.start_us] + [x for iv in merged for x in iv] \
            + [self.end_us]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        hosts = sorted(self.host)
        starts = [h[0] for h in hosts]
        return [[self._host_at(s + d / 2, starts, hosts), d / 1e6]
                for d, s in gaps]


def profiled(fn: Callable[[], object], host: bool = False
             ) -> Tuple[object, Trace]:
    """``fn()`` under the profiler.  With ``host`` the host's ranges are
    recorded too, inside a ``WINDOW`` range that gives the window's ends;
    that slows the host several-fold, so without it only the device's
    operations are recorded (CUPTI) and the window is the host clock's
    length, from the first operation's start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = ([ProfilerActivity.CPU] if host or not cuda else []) \
        + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities):
        pass  # the tracer's one-time start, outside the window
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW) if host else contextlib.nullcontext():
            out = fn()
            sync()
        host_s = time.perf_counter() - t0
    device, hosts, window = [], [], None
    for e in prof.events():
        iv = (float(e.time_range.start), float(e.time_range.end), e.name)
        if e.device_type == DeviceType.CUDA:
            if e.name != WINDOW:  # the range's own device-side annotation
                device.append(iv)
        elif e.name == WINDOW:
            window = iv
        else:
            hosts.append(iv)
    if window is None:
        start = min((iv[0] for iv in device), default=0.0)
        window = (start, start + host_s * 1e6)
    return out, Trace(window[0], window[1], device, hosts, host_s)
