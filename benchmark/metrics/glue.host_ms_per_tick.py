"""Host time per tick of the port's glue: the ``fleet.tick`` spans' time
less the ``launch.*`` spans inside them, which leaves the Python and
PyTorch dispatch of ``ocp/solver.py``, ``fleet.py`` and
``experiments/quad_fleet.py``. Nothing to read without the spans."""

from benchmark import spans


def read(ctx):
    ticks = spans.ticks(ctx.trace)
    if not ticks:
        return None
    launches = spans.launches(ctx.trace)
    glue_us = sum((t[2] - t[1]) - sum(h[2] - h[1] for h in launches if spans.inside(h, t))
                  for t in ticks)
    return glue_us / 1e3 / len(ticks)
