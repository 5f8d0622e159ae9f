"""The sensitivity sweep's share of its roofline (``csrc/vde.cuh`` with the
configuration's functor, via ``ops/cuda_vde.py``): the least time of one
launch from the configuration's frozen counts over the device time per
launch in the trace. Nothing to read where no launch matches."""

from benchmark import trace, yardstick

PATTERNS = [r"\bvde_kernel\b"]


def read(ctx):
    ops = trace.matching(ctx.trace, PATTERNS)
    if not ops:
        return None
    ms = sum(o.end_us - o.start_us for o in ops) / 1e3 / len(ops)
    bound = yardstick.kernel_bounds(ctx.cfg, ctx.batch)["vde"][0]
    return 100.0 * bound / ms
