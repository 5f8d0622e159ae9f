"""Chained batched small-matrix product in the lane layout: CUDA kernel
wrapper and plain version.

Replaces ``ad_mpc_tpu/experiments/mxu_riccati.py:135`` ``kernel`` (built by
``lane_chain_build`` inside ``micro``). The kernel is ``csrc/lane_chain.cu``:
each scenario is split by column, warp k of a block carrying column k of
X <- A @ X through all ``chain`` links for 32 scenarios (one per lane), on
the batch-innermost (nx*nx, B) layout. :func:`chain_geometry` mirrors its
launch.

The plain version, :func:`lane_chain_plain`, repeats the Pallas body's
arithmetic entry by entry on (nx*nx, B) tensors. The wrapper runs it only
for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ad_mpc_tpu_torch.ops import _build

NX, CHAIN = 7, 12  # the one instance compiled in csrc/lane_chain.cu
LANES = 32  # scenarios per block: one per lane of each column's warp


class Geometry(NamedTuple):
    scenarios: int  # per block
    threads: int  # per block: a warp per column
    block_bytes: int  # shared bytes per block (A is read from global memory)
    blocks: int


def chain_geometry(batch, nx=NX):
    """The launch of ``csrc/lane_chain.cu`` for ``batch`` scenarios: one
    block of ``nx`` warps per ``LANES`` scenarios, the last one ragged."""
    return Geometry(LANES, nx * LANES, 0, -(-batch // LANES))


def _lib():
    lib = _build.load("lane_chain")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.lane_chain.argtypes = [P, P, P, I, I, I, P]
        lib.lane_chain.restype = I
        lib.lane_chain_occupancy.argtypes = [I, I]
        lib.lane_chain_occupancy.restype = I
        lib.error_string.argtypes = [I]
        lib.error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def lane_chain_plain(a, x, chain):
    """X <- A @ X applied ``chain`` times, per scenario, on (nx*nx, B)
    tensors: entry i*nx+k accumulates a[i*nx] x[k] + a[i*nx+1] x[nx+k] + ...
    in the order of ``mxu_riccati.py:138-146``."""
    nx = round(a.shape[0] ** 0.5)
    for _ in range(chain):
        rows = []
        for i in range(nx):
            for k in range(nx):
                acc = a[i * nx] * x[k]
                for j in range(1, nx):
                    acc = acc + a[i * nx + j] * x[j * nx + k]
                rows.append(acc)
        x = torch.stack(rows)
    return x


def to_lanes(m):
    """(B, nx, nx) batch-first -> (nx*nx, B) batch-innermost, contiguous."""
    return m.reshape(m.shape[0], -1).T.contiguous()


def from_lanes(m, nx):
    """(nx*nx, B) -> (B, nx, nx)."""
    return m.T.reshape(-1, nx, nx)


class LaneChain:
    """``chain`` applications of X <- A @ X per scenario.

    ``__call__(a, x)`` takes float32 tensors in the lane layout (nx*nx, B)
    and returns the same layout, or batch-first (B, nx, nx) tensors, which
    it transposes around the kernel as ``lane_chain_build`` does
    (``mxu_riccati.py:150-151, 163``). ``launches`` counts kernel launches
    made through the wrapper; the replays of a CUDA graph that captured a
    launch do not pass through it.
    """

    def __init__(self, nx=NX, chain=CHAIN):
        self.nx, self.chain = nx, chain
        self.launches = 0

    def occupancy(self):
        """Blocks of the kernel resident on one SM of the card, by
        ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
        lib = _lib()
        n = lib.lane_chain_occupancy(self.nx, self.chain)
        if n < 0:
            raise RuntimeError(f"lane_chain_occupancy: {lib.error_string(-n).decode()}")
        return n

    def __call__(self, a, x):
        if a.dim() == 3:
            return from_lanes(self(to_lanes(a), to_lanes(x)), self.nx)
        if a.device.type == "cpu":
            return lane_chain_plain(a, x, self.chain)
        if a.device.type != "cuda":
            raise ValueError(f"LaneChain: unsupported device {a.device}")
        return self._launch(a, x)

    def _launch(self, a, x):
        nx = self.nx
        for name, t in (("a", a), ("x", x)):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"LaneChain: {name} must be contiguous float32")
            if t.device != a.device or t.dim() != 2 or t.shape != a.shape \
                    or t.shape[0] != nx * nx:
                raise ValueError(f"LaneChain: {name} {tuple(t.shape)} on "
                                 f"{t.device}, expected ({nx * nx}, B) on {a.device}")
        lib = _lib()
        o = torch.empty_like(a)
        err = lib.lane_chain(a.data_ptr(), x.data_ptr(), o.data_ptr(),
                             a.shape[1], nx, self.chain,
                             torch.cuda.current_stream(a.device).cuda_stream)
        if err:
            raise RuntimeError(f"lane_chain: {lib.error_string(err).decode()}")
        self.launches += 1
        return o


def make_lane_chain(nx=NX, chain=CHAIN, device="cuda"):
    """Build the chain for ``device``. On a CUDA device only nx=7, chain=12
    is compiled, and the kernel is built now."""
    if torch.device(device).type == "cuda":
        if (nx, chain) != (NX, CHAIN):
            raise NotImplementedError(f"lane_chain kernel: nx={nx}, chain={chain}")
        _build.require_card(device)
        _lib()
    return LaneChain(nx, chain)
