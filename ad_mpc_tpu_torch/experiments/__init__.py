"""experiments layer of the PyTorch/CUDA port (see the package docstring)."""

from __future__ import annotations

import contextlib
import subprocess
from typing import NamedTuple

import torch


def card() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit`` prints them, or torch's name of device 0 without it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def require_cuda(device) -> torch.device:
    """A measurement runs on a CUDA device or not at all."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"this measurement times a CUDA device; "
                           f"device={str(device)!r}, CUDA available: "
                           f"{torch.cuda.is_available()}")
    return device


@contextlib.contextmanager
def tf32(on: bool):
    """Set ``torch.backends.cuda.matmul.allow_tf32`` inside the block and
    restore it after, also on an exception."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


FLUSH_BYTES = 128 * 2**20  # written between calls to evict the H100's 50 MB L2


class DeviceWindow:
    """Device time between two CUDA events around ``with`` (``.s`` after)."""

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        self.end.record()
        self.end.synchronize()
        self.s = self.start.elapsed_time(self.end) / 1e3


def capture(block, x0, counter=None):
    """Run ``block(x0)`` once on a side stream (the warm-up PyTorch asks
    for before a capture), then capture ``x <- block(x)`` into a CUDA
    graph over a static carry ``x``. Returns (graph, x, ref, captured):
    ``ref`` is the warm-up's output, ``captured`` the launches of
    ``counter`` (a kernel wrapper) recorded in the graph; replays do not
    pass through the wrapper."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ref = block(x0)
    torch.cuda.current_stream().wait_stream(side)
    x = torch.empty_like(x0)
    before = counter.launches if counter is not None else 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x.copy_(block(x))
    captured = counter.launches - before if counter is not None else None
    return graph, x, ref, captured


class Replays(NamedTuple):
    s: float  # device seconds per replay of the block, min over rounds
    spread: float  # max / min over rounds
    ref: torch.Tensor  # the warm-up block's output from x0
    replays: int  # graph replays made
    captured: int | None  # launches of ``counter`` recorded in the graph


def time_replays(block, x0, *, rounds=5, target_s=0.6, counter=None):
    """Device time of one ``block`` by CUDA-graph replay (:func:`capture`),
    so the host's launch rate drops out. The carry chains from the warm-up
    output through every replay; the replays per round are calibrated to
    about ``target_s`` of device time, each round timed by CUDA events."""
    graph, x, ref, captured = capture(block, x0, counter)
    x.copy_(ref)

    def round_time(n):
        with DeviceWindow() as w:
            for _ in range(n):
                graph.replay()
        return w.s

    t_cal = round_time(2)
    n = max(int(target_s / max(t_cal / 2, 1e-5)), 2)
    ts = [round_time(n) / n for _ in range(rounds)]
    return Replays(min(ts), max(ts) / min(ts), ref, 2 + rounds * n, captured)


def graph_ms(fn, inner=20, rounds=5, target_s=0.3, cold=False):
    """Device time per call of ``fn`` by CUDA-graph replay: ``inner`` calls
    captured in one graph (:func:`time_replays`), so neither the host's
    launch rate nor a profiler enters. Warm: inputs that fit the L2 stay
    there. ``cold``: ``FLUSH_BYTES`` written before each call in the graph,
    so every call finds its inputs out of L2; a graph of the writes alone is
    replayed too and its time subtracted. ``fn`` launches on the current
    stream and never waits for the card."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda") if cold else None

    def timed(body):
        def block(x):
            for _ in range(inner):
                body()
            return x

        return time_replays(block, torch.zeros(1, device="cuda"), rounds=rounds,
                            target_s=target_s).s

    if not cold:
        return 1e3 * timed(fn) / inner

    def flushed():
        flush.fill_(1.0)
        fn()

    return 1e3 * (timed(flushed) - timed(lambda: flush.fill_(1.0))) / inner


def tick_qp_inputs(tick, init, solver, batch, ticks=3):
    """The inputs of the last QP that ``solver``'s QP module ran in
    ``ticks`` ticks of a fleet of ``batch`` vehicles."""
    captured = []
    hook = solver.qp.register_forward_pre_hook(lambda mod, a: captured.append(a))
    try:
        carry = init(batch)
        for _ in range(ticks):
            carry, _ = tick(carry)
    finally:
        hook.remove()
    return captured[-1]
