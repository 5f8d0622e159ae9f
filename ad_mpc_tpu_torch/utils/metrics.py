"""Latency and throughput metrics and a profiler hook.

Port of ``ad_mpc_tpu/utils/metrics.py``: p50/p99 latency counters and a
solves-per-second window, as they are, and :func:`profile_trace`, which
wraps a region in ``torch.profiler`` (the JAX package's ``jax.profiler``
trace) and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np


class LatencyTracker:
    """Per-event latency accumulator with percentile reporting."""

    def __init__(self, name: str = "solve", budget_ms: float | None = None):
        self.name = name
        self.budget_ms = budget_ms
        self._samples_ms: list[float] = []

    @contextlib.contextmanager
    def measure(self):
        tic = time.perf_counter()
        try:
            yield
        finally:
            self._samples_ms.append(1e3 * (time.perf_counter() - tic))

    def add(self, seconds: float):
        self._samples_ms.append(1e3 * seconds)

    def __len__(self):
        return len(self._samples_ms)

    def stats(self, skip_warmup: int = 0) -> dict:
        a = np.asarray(self._samples_ms[skip_warmup:])
        if len(a) == 0:
            return {"name": self.name, "count": 0}
        out = {
            "name": self.name,
            "count": int(len(a)),
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
            "max_ms": float(a.max()),
            "rate_hz": float(1e3 / a.mean()),
        }
        if self.budget_ms is not None:
            out["budget_ms"] = self.budget_ms
            out["overruns"] = int(np.sum(a > self.budget_ms))
        return out

    def reset(self):
        self._samples_ms.clear()


class ThroughputTracker:
    """Batched-solve throughput (solves/s) over timed windows."""

    def __init__(self):
        self._windows: list[tuple[int, float]] = []

    @contextlib.contextmanager
    def window(self, n_items: int):
        tic = time.perf_counter()
        try:
            yield
        finally:
            self._windows.append((n_items, time.perf_counter() - tic))

    def rate(self) -> float:
        if not self._windows:
            return 0.0
        items = sum(n for n, _ in self._windows)
        secs = sum(t for _, t in self._windows)
        return items / max(secs, 1e-12)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile a region with ``torch.profiler`` (the CPU, and the card's
    kernels where there is one) and write ``trace.json`` (Chrome trace
    format) into ``log_dir``. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
