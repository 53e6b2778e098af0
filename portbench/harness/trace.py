"""The traced slice of a ``--trace 1`` run: one ``torch.profiler`` session
over a bounded steady part of the window, reduced to device time by
kernel name, the device's busy time (the union of its operations'
intervals), the slice's length, and the idle gaps by what the host was
doing meanwhile."""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch

SLICE = "portbench.slice"
# The profiler's own host events, which say nothing of what the run did.
PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush",
                "Command Buffer Full")


def warm_up() -> None:
    """One empty session: the profiler's own start-up is set-up, not
    slice."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()


def profiled(fn):
    """``fn()`` inside a profiler session; returns (fn's result, the
    slice's reduction)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SLICE):
            out = fn()
            torch.cuda.synchronize()
    return out, reduce(prof.events())


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events) -> dict:
    """Device microseconds and counts by name, busy and slice seconds,
    and idle gaps by the innermost host operation under the gap's middle
    (all in seconds)."""
    from torch.autograd import DeviceType
    span = next(e.time_range for e in events
                if e.device_type == DeviceType.CPU and e.name == SLICE)
    lo, hi = span.start, span.end
    kernels = defaultdict(lambda: [0.0, 0])
    dev, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith("portbench.") and e.device_type != DeviceType.CPU:
            continue          # our own spans, mirrored on the device
        if e.name == SLICE or e.name in PROFILER_OWN:
            continue
        if e.device_type == DeviceType.CUDA:
            if b <= lo or a >= hi:
                continue
            a, b = max(a, lo), min(b, hi)
            k = kernels[e.name]
            k[0] += b - a
            k[1] += 1
            dev.append((a, b))
        elif lo <= a <= hi:
            host.append((a, b, e.name))
    busy = _merge(dev)
    host.sort()
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    prev = lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            mid = 0.5 * (a + prev)
            gaps[_under(host, starts, mid)] += (a - prev) / 1e6
        prev = max(prev, b)
    return dict(
        kernels={k: (v[0], v[1]) for k, v in kernels.items()},
        busy_s=sum(b - a for a, b in busy) / 1e6,
        window_s=(hi - lo) / 1e6,
        events=len(dev),
        gaps=dict(gaps))


def _under(host, starts, t, walk: int = 4096) -> str:
    """The innermost host operation running at ``t``: the latest-starting
    one that covers it (host operations nest)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - walk), -1):
        a, b, name = host[j]
        if b >= t:
            return name
    return "host: no traced operation"


def top(d: dict, n: int = 10, scale: float = 1.0, width: int = 160) -> list:
    """The ``n`` largest entries as [name, value * scale], names cut to
    ``width`` characters (kernels' template arguments run long)."""
    return [[k[:width], v * scale] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]
