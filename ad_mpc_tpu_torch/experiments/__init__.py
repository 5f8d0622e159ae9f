"""experiments layer of the PyTorch/CUDA port (see the package docstring)."""

from __future__ import annotations

import contextlib
import subprocess

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
