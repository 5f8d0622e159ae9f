"""The share of the profiled ticks' wall time in which the device idled
inside the port's ``fleet.tick`` spans: the device's gaps while the host
enqueues a tick. What is left of ``device.idle_pct`` lies between ticks,
in the client's fetch and publish. Nothing to read without the spans."""

from benchmark import spans, trace


def read(ctx):
    ticks = spans.ticks(ctx.trace)
    if not ticks or ctx.trace.wall_s <= 0:
        return None
    busy = trace.busy_intervals(ctx.trace)
    idle_us = sum((b - a) - spans.covered(busy, a, b) for _, a, b in ticks)
    return 100.0 * idle_us / 1e6 / ctx.trace.wall_s
