"""Fused RK4 + VDE linearization sweep, and the plain RK4 map: CUDA kernel
wrappers and plain versions.

:class:`VDE` replaces ``ad_mpc_tpu/ops/pallas_vde.py:_vde_kernel`` (built by
its ``make_vde``). The kernel is ``csrc/vde.cu``: one thread per (scenario,
stage), forward-mode dual numbers for the exact sensitivities of the RK4
map, written into the batch-first layout the solver uses through a per-warp
tile in shared memory.

:class:`RK4` runs the same functor and RK4 map without tangents: the
solver's KKT defect and the fleet's plant step, which the JAX package's
jitted tick leaves to XLA to fuse.

The plain versions are :func:`vde_plain` (``integrators.linearize``, i.e.
``torch.func.vmap(jacfwd)``, vmapped over the batch) and
``integrators.discrete_step``. A wrapper runs its plain version only for
CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn
from torch.func import vmap

from ad_mpc_tpu_torch.ops import _build
from ad_mpc_tpu_torch.ops.integrators import discrete_step, discretize, linearize

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C signature of each kind of entry, before (dt, rk4_steps, params, stream).
_ARGS = {
    "cuda_entry": [_P] * 6 + [_I] * 5,  # vde_<model>
    "cuda_rk4_entry": [_P, _L, _P, _L, _L, _P, _L, _P] + [_I] * 6,  # rk4_<model>
}


def _entry_name(f, kind="cuda_entry"):
    """The C entry of ``csrc/vde.cu`` that runs a kernel with the functor
    of the dynamics ``f`` (its ``cuda_entry`` or ``cuda_rk4_entry``)."""
    name = getattr(f, kind, None)
    if name is None:
        raise NotImplementedError(
            f"no CUDA functor in csrc/vde.cu for dynamics {f!r}")
    return name


def _entry(f, kind="cuda_entry", defines=()):
    """(C entry of ``f``, ``error_string``), the entry typed for the
    parameter struct that ``f.cuda_params()`` builds. ``defines`` build
    ``csrc/vde.cu`` with those ``-D`` macros (its functors' traits)."""
    lib = _build.load("vde", defines)
    fn = getattr(lib, _entry_name(f, kind))
    if fn.argtypes is None:
        fn.argtypes = _ARGS[kind] + [ctypes.c_double, _I,
                                     type(f.cuda_params()), _P]
        fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
    return fn, lib.error_string


def _check_shape(what, f, nx, nu):
    """The functor of ``f`` has the sweep's (nx, nu)."""
    if (getattr(f, "nx", nx), getattr(f, "nu", nu)) != (nx, nu):
        raise ValueError(f"{what}: nx={nx}, nu={nu}, but the functor of {f!r} "
                         f"has nx={f.nx}, nu={f.nu}")


def _check(name, t, shape, device, contiguous=True):
    """float32 on ``device`` with ``shape``; contiguous, or with a
    contiguous last axis when ``contiguous`` is False."""
    if t.dtype != torch.float32 or not (
            t.is_contiguous() if contiguous else t.stride(-1) == 1):
        raise ValueError(f"{name} must be float32 with a contiguous "
                         f"{'layout' if contiguous else 'last axis'}")
    if t.device != device or tuple(t.shape) != shape:
        raise ValueError(f"{name} {tuple(t.shape)} on {t.device}, expected "
                         f"{shape} on {device}")


def _run(fn, error_string, f, device, *args):
    """Launch the entry ``fn`` on ``device``'s current stream; raise on a
    refused launch."""
    err = fn(*args, f.cuda_params(), torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn.__name__}: {error_string(err).decode()}")


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
    us (B,N,nu), ps (B,p_dim) and returns (A (B,N,nx,nx), Bm (B,N,nx,nu),
    c (B,N,nx)). N is the horizon the sweep was made for; a launch takes
    its horizon from ``us``, so that N one-stage scenarios (B=N, N=1) run a
    horizon with a parameter row per stage. ``launches`` counts kernel
    launches; ``defines`` are the ``-D`` macros the kernel is built with
    (none on the main path).
    """

    def __init__(self, f, dt, N, nx, nu, p_dim, rk4_steps=1):
        super().__init__()
        self.f = f
        self.dt, self.N, self.nx, self.nu = float(dt), N, nx, nu
        self.p_dim, self.rk4_steps = p_dim, rk4_steps
        self.defines = ()
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
        (B, N), nx, nu = us.shape[:2], self.nx, self.nu
        _check_shape("VDE", self.f, nx, nu)
        fn, error_string = _entry(self.f, defines=self.defines)
        for name, t, shape in (("xs", xs, (B, N + 1, nx)),
                               ("us", us, (B, N, nu)),
                               ("ps", ps, (B, self.p_dim))):
            _check(f"VDE: {name}", t, shape, xs.device)
        A = torch.empty((B, N, nx, nx), dtype=torch.float32, device=xs.device)
        Bm = torch.empty((B, N, nx, nu), dtype=torch.float32, device=xs.device)
        c = torch.empty((B, N, nx), dtype=torch.float32, device=xs.device)
        _run(fn, error_string, self.f, xs.device, xs.data_ptr(), us.data_ptr(),
             ps.data_ptr(), A.data_ptr(), Bm.data_ptr(), c.data_ptr(), B, N,
             nx, nu, ps.shape[-1], self.dt, self.rk4_steps)
        self.launches += 1
        return A, Bm, c


class RK4(nn.Module):
    """The batched RK4 map ``F(x, u; p)`` of ``f``, with no tangents: the
    VDE kernel's functor and RK4 map instantiated for ``float``.

    ``forward(x, u, p)`` is one step: x (M,nx), u (M,nu), p (M,p_dim) ->
    F(x, u) (M,nx); u may be a strided view such as ``us[:, 0]``, with a
    contiguous last axis. ``defect(xs, us, ps)`` is the multiple-shooting
    defect F(x_k, u_k) - x_{k+1}: xs (B,N+1,nx), us (B,N,nu), ps (B,p_dim)
    -> (B,N,nx), the sweep's ``c``. All float32. ``launches`` counts kernel
    launches; ``defines`` are the ``-D`` macros the kernel is built with
    (none on the main path).
    """

    def __init__(self, f, dt, nx, nu, p_dim, rk4_steps=1):
        super().__init__()
        self.f = f
        self.dt, self.nx, self.nu = float(dt), nx, nu
        self.p_dim, self.rk4_steps = p_dim, rk4_steps
        self.defines = ()
        self.launches = 0

    def plain(self, x, u, p):
        """``integrators.discrete_step`` with this map's dynamics and step."""
        return discrete_step(self.f, self.dt, self.rk4_steps, x, u, p)

    def defect_plain(self, xs, us, ps):
        """Plain version of :meth:`defect`."""
        return self.plain(xs[:, :-1], us, ps[:, None]) - xs[:, 1:]

    def forward(self, x, u, p):
        if x.device.type == "cpu":
            return self.plain(x, u, p)
        M = x.shape[0]
        _check("RK4: x", x, (M, self.nx), x.device, contiguous=False)
        _check("RK4: u", u, (M, self.nu), x.device, contiguous=False)
        _check("RK4: p", p, (M, self.p_dim), x.device, contiguous=False)
        return self._launch(x, x.stride(0), u, u.stride(0), 0, p, M, 1, 0)

    def defect(self, xs, us, ps):
        if xs.device.type == "cpu":
            return self.defect_plain(xs, us, ps)
        B, N = us.shape[:2]
        _check("RK4: xs", xs, (B, N + 1, self.nx), xs.device)
        _check("RK4: us", us, (B, N, self.nu), xs.device, contiguous=False)
        _check("RK4: ps", ps, (B, self.p_dim), xs.device, contiguous=False)
        return self._launch(xs, xs.stride(0), us, us.stride(0), us.stride(1),
                            ps, B, N, 1)

    def _launch(self, x, x_b, u, u_b, u_k, p, batch, N, defect):
        if x.device.type != "cuda":
            raise ValueError(f"RK4: unsupported device {x.device}")
        _check_shape("RK4", self.f, self.nx, self.nu)
        fn, error_string = _entry(self.f, "cuda_rk4_entry", self.defines)
        out = torch.empty((batch, N, self.nx) if defect else (batch, self.nx),
                          dtype=torch.float32, device=x.device)
        # p_dim = 0: the kernel reads no parameter, and the empty tensor's
        # null pointer is passed with stride 0.
        p_b = p.stride(0) if self.p_dim else 0
        _run(fn, error_string, self.f, x.device, x.data_ptr(), x_b, u.data_ptr(), u_b,
             u_k, p.data_ptr(), p_b, out.data_ptr(), batch, N, self.nx, self.nu,
             self.p_dim, defect, self.dt, self.rk4_steps)
        self.launches += 1
        return out


def _prepare(f, device, kind, nx, nu):
    """On a CUDA device: refuse a dynamics without a CUDA functor, with
    another (nx, nu) or with parameters its functor cannot take, then
    require the card and build the kernel now."""
    if torch.device(device).type == "cuda":
        _entry_name(f, kind)
        _check_shape(kind, f, nx, nu)
        f.cuda_params()
        _build.require_card(device)
        _entry(f, kind)


def make_vde(f, dt, N, nx, nu, p_dim, rk4_steps=1, device="cuda"):
    """Build the fused linearization sweep for ``device``."""
    _prepare(f, device, "cuda_entry", nx, nu)
    return VDE(f, dt, N, nx, nu, p_dim, rk4_steps).to(device)


def make_rk4(f, dt, nx, nu, p_dim, rk4_steps=1, device="cuda"):
    """Build the tangent-free RK4 map for ``device``."""
    _prepare(f, device, "cuda_rk4_entry", nx, nu)
    return RK4(f, dt, nx, nu, p_dim, rk4_steps).to(device)
