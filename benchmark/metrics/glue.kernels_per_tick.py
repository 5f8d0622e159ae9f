"""Device kernels per tick in the trace, of every kind (the port's three
and PyTorch's own): a count of the launches the host pays for."""


def read(ctx):
    if not ctx.trace.ticks:
        return None
    return sum(1 for o in ctx.trace.ops if o.kernel) / ctx.trace.ticks
