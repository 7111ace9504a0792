"""Reading a torch.profiler window over a stretch of the timed path: the
device's busy time (the union of its operations' intervals: kernels,
copies and sets), the window's length, the operations that took most time,
and the idle gaps named by what the host was doing meanwhile.

The stretch runs inside a record_function span named STRETCH that ends
after a synchronise, so the window is that span, widened to any device
operation that lies outside it.
"""

from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

STRETCH = "bench.stretch"
TOP = 10
NAME_CHARS = 160  # of an operation's name in the breakdown


@dataclass
class Trace:
    busy_s: float = 0.0
    window_s: float = 0.0
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def gaps(busy: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no merged interval covers."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def host_name(host: List[Tuple[float, float, str]], starts: List[float],
              t: float) -> str:
    """The innermost host span open at time t (the latest started), or
    "host_idle". host: sorted by start; starts: their starts."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if host[i][1] > t:
            return host[i][2]
    return "host_idle"


def profile(run: Callable[[], None], device) -> Trace:
    """Run `run()` (which ends with a synchronise) under torch.profiler
    inside the STRETCH span and read the trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as tprofile

    cuda = device.type == "cuda"
    with tprofile(activities=[ProfilerActivity.CPU]
                  + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        with record_function(STRETCH):
            run()
            if cuda:
                torch.cuda.synchronize(device)
    dev, host, span = [], [], None
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            # A record_function range is mirrored on the device's timeline
            # as an annotation, which is no operation.
            if (b > a and not getattr(e, "is_user_annotation", False)
                    and not e.name.startswith("bench.")):
                dev.append((a, b, e.name[:NAME_CHARS]))
        elif e.name == STRETCH:
            span = (a, b)
        elif b > a:
            host.append((a, b, e.name))
    return read(dev, host, span)


def read(dev: List[Tuple[float, float, str]],
         host: List[Tuple[float, float, str]],
         span) -> Trace:
    """A Trace of device intervals (start s, end s, name), host spans and
    the stretch's span."""
    if not dev or span is None:
        return Trace()
    lo = min(span[0], min(a for a, _, _ in dev))
    hi = max(span[1], max(b for _, b, _ in dev))
    busy = union([(a, b) for a, b, _ in dev])
    by_op: Dict[str, float] = collections.defaultdict(float)
    for a, b, n in dev:
        by_op[n] += b - a
    host = sorted((a, b, n) for a, b, n in host if b > lo and a < hi)
    starts = [a for a, _, _ in host]
    idle: Dict[str, float] = collections.defaultdict(float)
    for a, b in gaps(busy, lo, hi):
        idle[host_name(host, starts, (a + b) / 2)] += b - a
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(busy_s=sum(b - a for a, b in busy), window_s=hi - lo,
                 device_ops=[[n, s] for n, s in top(by_op)],
                 idle_gaps=[[n, s] for n, s in top(idle)])
