"""The reduction of a ``torch.profiler`` block to what the per-layer
metrics read.

The traced run profiles a fixed block of whole ticks inside its window
(CPU and CUDA activities). :func:`reduce` keeps, from the profiler's
events, every device operation (kernels, copies, fills) with its name and
interval, and every host operation with its interval, on the profiler's
one clock. The device is busy where any device operation runs (the union
of their intervals); the idle gaps are named by the innermost host
operation running at their middle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DeviceOp(NamedTuple):
    name: str
    start_us: float
    end_us: float
    kernel: bool  # a kernel, not a copy or a fill


class Trace(NamedTuple):
    ops: list  # DeviceOp, by start
    host: list  # (name, start_us, end_us) of host operations
    ticks: int  # whole ticks in the block
    wall_s: float  # host clock from the block's first call to its last fetch


def _is_copy(name: str) -> bool:
    n = name.lower()
    return n.startswith("memcpy") or n.startswith("memset")


def reduce(prof, ticks: int, wall_s: float) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``."""
    ops, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        tr = e.time_range
        if e.device_type == cuda:
            ops.append(DeviceOp(e.name, tr.start, tr.end, not _is_copy(e.name)))
        else:
            host.append((e.name, tr.start, tr.end))
    ops.sort(key=lambda o: o.start_us)
    return Trace(ops, host, ticks, wall_s)


def busy_intervals(tr: Trace) -> list:
    """The union of the device operations' intervals, in order."""
    out = []
    for o in tr.ops:
        if out and o.start_us <= out[-1][1]:
            out[-1][1] = max(out[-1][1], o.end_us)
        else:
            out.append([o.start_us, o.end_us])
    return out


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(tr)) / 1e6


def matching(tr: Trace, patterns) -> list:
    """The kernels whose name matches one of the regular expressions."""
    import re

    rx = [re.compile(p) for p in patterns]
    return [o for o in tr.ops if o.kernel and any(r.search(o.name) for r in rx)]


def device_ops(tr: Trace, top: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time,
    summed by name."""
    by = {}
    for o in tr.ops:
        by[o.name] = by.get(o.name, 0.0) + (o.end_us - o.start_us) / 1e6
    return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(tr: Trace, top: int = 10) -> list:
    """[[what the host was doing, seconds]] of the longest gaps between
    device operations: the innermost host operation over the gap's
    middle, or ``host (no operation)``."""
    busy = busy_intervals(tr)
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    gaps.sort(key=lambda g: -g[0])
    out = []
    for dur, a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        inner = [h for h in tr.host if h[1] <= mid <= h[2]]
        name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "host (no operation)"
        out.append([name[:120], dur / 1e6])
    return out
