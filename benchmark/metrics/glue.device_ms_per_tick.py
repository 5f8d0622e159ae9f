"""Device time per tick of every kernel that is not one of the port's
three (the sweep, the RK4 map, the LQ kernel): the plain PyTorch glue of
``ocp/solver.py``, ``fleet.py`` and ``experiments/quad_fleet.py``. Copies
and fills are not kernels and are left out."""

from benchmark import trace

PORT_KERNELS = [r"\bvde_kernel\b", r"\brk4_kernel\b", r"\blq_ipm_kernel\b",
                r"\blq_ipm_wide_kernel\b"]


def read(ctx):
    port = {id(o) for o in trace.matching(ctx.trace, PORT_KERNELS)}
    glue = [o for o in ctx.trace.ops if o.kernel and id(o) not in port]
    if not ctx.trace.ticks:
        return None
    return sum(o.end_us - o.start_us for o in glue) / 1e3 / ctx.trace.ticks
