"""Named spans on the profiler's clock, and a profiler hook.

:func:`span` names a region of the port's host code (the fleet's tick,
the solver's phases, the kernel wrappers' host side) in a running
``torch.profiler``, where it shares a clock with the device's kernels.
With no profiler running it costs one check. :func:`profile_trace` wraps
a region in ``torch.profiler`` (the JAX package's ``jax.profiler`` trace)
and writes a Chrome trace, in which the spans appear on the host's rows.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch._C._profiler import _RecordFunctionFast

_profiling = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()

# The first words of the port's span names.
SPAN_PREFIXES = ("fleet.", "solver.", "launch.")


def span(name: str):
    """A context that records ``name`` as a host event of the running
    ``torch.profiler``, or the one shared no-op context when none runs.

    The event is a plain record function, not a user annotation, so the
    profiler copies nothing of it onto the device's timeline. A span's
    parent is the span whose interval encloses it."""
    return _RecordFunctionFast(name) if _profiling() else _OFF


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile a region with ``torch.profiler`` (the CPU, and the card's
    kernels where there is one) and write ``trace.json`` (Chrome trace
    format) into ``log_dir``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
