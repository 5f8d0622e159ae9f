"""The share of the profiled ticks' wall time in which no operation ran on
the device (one stream): 100 (1 - busy / wall), busy the union of the
device operations' intervals in the trace."""

from benchmark import trace


def read(ctx):
    if not ctx.trace.ops or ctx.trace.wall_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(ctx.trace) / ctx.trace.wall_s)
