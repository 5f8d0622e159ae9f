"""The LQ interior-point kernel's share of its roofline (``csrc/lq_ipm.cu``,
7x2, and ``csrc/lq_ipm_wide.cuh``, 13x4, via ``ops/cuda_lq.py``): the
least time of one launch from the configuration's frozen counts over the
device time per launch in the trace. Nothing to read where no launch
matches."""

from benchmark import trace, yardstick

PATTERNS = [r"\blq_ipm_kernel\b", r"\blq_ipm_wide_kernel\b"]


def read(ctx):
    ops = trace.matching(ctx.trace, PATTERNS)
    if not ops:
        return None
    ms = sum(o.end_us - o.start_us for o in ops) / 1e3 / len(ops)
    bound = yardstick.kernel_bounds(ctx.cfg, ctx.batch)["lq_ipm"][0]
    return 100.0 * bound / ms
