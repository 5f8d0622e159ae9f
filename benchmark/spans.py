"""The port's own spans in a reduced trace (``benchmark/trace.py``).

The port names regions of its host code with events of the running
profiler (``fleet.tick`` around the fleet's whole ``tick(carry)``,
``launch.<kernel>`` around a kernel wrapper's host side, and the solver's
phases), which :func:`benchmark.trace.reduce` keeps among the host's
operations, on the clock the device's operations share. A program without
them gives no ``fleet.tick`` span, and the readers built on this module
then find nothing to read.
"""

from __future__ import annotations

TICK = "fleet.tick"
LAUNCH = "launch."


def ticks(tr) -> list:
    """The ``fleet.tick`` spans of the trace, (name, start_us, end_us), by
    start."""
    return sorted((h for h in tr.host if h[0] == TICK), key=lambda h: h[1])


def launches(tr) -> list:
    """The ``launch.*`` spans of the trace."""
    return [h for h in tr.host if h[0].startswith(LAUNCH)]


def inside(h, span) -> bool:
    """Whether the host event ``h`` lies within the interval of ``span``."""
    return span[1] <= h[1] and h[2] <= span[2]


def covered(intervals, a: float, b: float) -> float:
    """Microseconds of [a, b] that the disjoint ``intervals`` cover."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in intervals)
