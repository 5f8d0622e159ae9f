"""The median host time for the fleet's ``tick(carry)`` to return, before
its outputs are fetched (``fleet.py``, ``experiments/quad_fleet.py``): the
time the host takes to enqueue a tick, on the benchmark's own clock, over
the window's ticks outside the profiled block."""

import statistics


def read(ctx):
    if not ctx.enqueue_ms:
        return None
    return statistics.median(ctx.enqueue_ms)
