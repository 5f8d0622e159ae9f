"""Fused RK4 + VDE linearization sweep: CUDA kernel wrapper and plain version.

Replaces ``ad_mpc_tpu/ops/pallas_vde.py:_vde_kernel`` (built by its
``make_vde``). The kernel is ``csrc/vde.cu``: one thread per (scenario,
stage), forward-mode dual numbers for the exact sensitivities of the RK4
map, written straight into the batch-first layout the solver uses.

The plain version, :func:`vde_plain`, is ``integrators.linearize``
(``torch.func.vmap(jacfwd)``) vmapped over the batch. The wrapper runs it
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn
from torch.func import vmap

from ad_mpc_tpu_torch.ops import _build
from ad_mpc_tpu_torch.ops.integrators import discretize, linearize


def _entry_name(f):
    """The C entry of ``csrc/vde.cu`` that runs the kernel with the functor
    of the dynamics ``f`` (its ``cuda_entry``)."""
    name = getattr(f, "cuda_entry", None)
    if name is None:
        raise NotImplementedError(
            f"no CUDA functor in csrc/vde.cu for dynamics {f!r}")
    return name


def _entry(f):
    """(C entry of ``f``, ``error_string``), the entry typed for the
    parameter struct that ``f.cuda_params()`` builds."""
    lib = _build.load("vde")
    fn = getattr(lib, _entry_name(f))
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.argtypes = [P] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_double, ctypes.c_int, type(f.cuda_params()), P]
        fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
    return fn, lib.error_string


def vde_plain(f, dt, rk4_steps, xs, us, ps):
    """Plain PyTorch version: per scenario, ``linearize`` of the RK4 map of
    ``f(x, u, p)``. xs (B,N+1,nx), us (B,N,nu), ps (B,pd) ->
    A (B,N,nx,nx), Bm (B,N,nx,nu), c (B,N,nx)."""

    def one(xs_b, us_b, p_b):
        F = discretize(lambda x, u: f(x, u, p_b), dt, rk4_steps)
        return linearize(F, xs_b, us_b)

    return vmap(one)(xs, us, ps)


class VDE(nn.Module):
    """Batched fused linearization sweep of ``f(x, u, p)`` over a horizon.

    ``forward(xs, us, ps)`` takes batch-first float32 tensors xs (B,N+1,nx),
    us (B,N,nu), ps (B,p_dim >= 1) and returns (A (B,N,nx,nx), Bm (B,N,nx,nu),
    c (B,N,nx)). ``launches`` counts kernel launches.
    """

    def __init__(self, f, dt, N, nx, nu, p_dim, rk4_steps=1):
        super().__init__()
        self.f = f
        self.dt, self.N, self.nx, self.nu = float(dt), N, nx, nu
        self.p_dim, self.rk4_steps = p_dim, rk4_steps
        self.launches = 0

    def plain(self, xs, us, ps):
        """:func:`vde_plain` with this sweep's dynamics and step."""
        return vde_plain(self.f, self.dt, self.rk4_steps, xs, us, ps)

    def forward(self, xs, us, ps):
        if xs.device.type == "cpu":
            return self.plain(xs, us, ps)
        if xs.device.type != "cuda":
            raise ValueError(f"VDE: unsupported device {xs.device}")
        return self._launch(xs, us, ps)

    def _launch(self, xs, us, ps):
        fn, error_string = _entry(self.f)
        B, N, nx, nu = xs.shape[0], self.N, self.nx, self.nu
        if (nx, nu) != (7, 2):
            raise NotImplementedError(f"VDE kernel: nx={nx}, nu={nu}")
        for name, t, shape in (("xs", xs, (B, N + 1, nx)),
                               ("us", us, (B, N, nu)),
                               ("ps", ps, (B, self.p_dim))):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"VDE: {name} must be contiguous float32")
            if t.device != xs.device or tuple(t.shape) != shape:
                raise ValueError(f"VDE: {name} {tuple(t.shape)} on {t.device},"
                                 f" expected {shape} on {xs.device}")
        A = torch.empty((B, N, nx, nx), dtype=torch.float32, device=xs.device)
        Bm = torch.empty((B, N, nx, nu), dtype=torch.float32, device=xs.device)
        c = torch.empty((B, N, nx), dtype=torch.float32, device=xs.device)
        err = fn(
            xs.data_ptr(), us.data_ptr(), ps.data_ptr(),
            A.data_ptr(), Bm.data_ptr(), c.data_ptr(),
            B, N, ps.shape[-1], self.dt, self.rk4_steps, self.f.cuda_params(),
            torch.cuda.current_stream(xs.device).cuda_stream,
        )
        if err:
            raise RuntimeError(f"{self.f.cuda_entry}: "
                               f"{error_string(err).decode()}")
        self.launches += 1
        return A, Bm, c


def make_vde(f, dt, N, nx, nu, p_dim, rk4_steps=1, device="cuda"):
    """Build the fused linearization sweep for ``device``. On a CUDA device
    the dynamics must have a CUDA functor and the kernel is built now."""
    if torch.device(device).type == "cuda":
        _entry_name(f)
        _build.require_card(device)
        _entry(f)
    return VDE(f, dt, N, nx, nu, p_dim, rk4_steps).to(device)
