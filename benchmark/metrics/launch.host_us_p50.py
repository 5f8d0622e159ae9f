"""The median host time of one kernel launch through the port's wrappers
(``ops/cuda_vde.py``, ``ops/cuda_lq.py``): the ``launch.*`` spans of the
profiled block, each the wrapper's checks, entry lookup, output
allocation and ctypes call. Nothing to read without the spans."""

import statistics

from benchmark import spans


def read(ctx):
    if not spans.ticks(ctx.trace):
        return None
    us = [h[2] - h[1] for h in spans.launches(ctx.trace)]
    return statistics.median(us) if us else None
