"""Fused RK4 + VDE linearization sweep, and the plain RK4 map: CUDA kernel
wrappers and plain versions.

:class:`VDE` replaces ``ad_mpc_tpu/ops/pallas_vde.py:_vde_kernel`` (built by
its ``make_vde``). The kernel is ``csrc/vde.cuh``'s ``vde_kernel``: one
thread per (scenario, stage), forward-mode dual numbers for the exact
sensitivities of the RK4 map, written into the batch-first layout the
solver uses through a per-warp tile in shared memory. The functor of a
dynamics lies in the source its ``cuda_source`` names
(``csrc/vde_<family>.cu``), each built into a library of its own.

:class:`RK4` runs the same functor and RK4 map without tangents: the
solver's KKT defect and the fleet's plant step, which the JAX package's
jitted tick leaves to XLA to fuse.

The plain versions are :func:`vde_plain` (``integrators.linearize``, i.e.
``torch.func.vmap(jacfwd)``, vmapped over the batch) and
``integrators.discrete_step``. A wrapper runs its plain version only for
CPU tensors; for CUDA tensors it launches the kernel or raises.

A team functor (a dynamics with ``cuda_team``: ``QuadDyn``,
``QuadDragDyn``, ``GPQuadDyn``, ``GPQuadDualDyn``, ``GPQuadDualDragDyn``,
``GPQuadSelectDyn``, ``GPQuadRoutedDyn``, ``PacejkaDyn``,
``GPBicycleDyn``) runs ``vde_kernel``'s team path, ROW_TEAM lanes per
(scenario, stage) row on the row's tangent columns in one pass; a team of
one lane (the Pacejka's and the GP bicycle's committed traits) is the
thread-per-row path, launched through the same entry. Its launch geometry
is :func:`vde_geometry`'s, from the traits
the library was built with (:meth:`VDE.team_traits`) and the bytes that
a functor stages after the block's tile: its table (its dynamics'
``cuda_table``) or, for a dynamics with ``cuda_rows``, the p rows of the
block's scenarios; here so that the CPU tests reach it; the C entry
refuses any other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import nn
from torch.func import vmap

from ad_mpc_tpu_torch.ops import _build
from ad_mpc_tpu_torch.ops.cuda_lq import SMEM_BLOCK_MAX, SMEM_BLOCK_RESERVED, SMEM_SM
from ad_mpc_tpu_torch.ops.integrators import discrete_step, discretize, linearize
from ad_mpc_tpu_torch.utils.metrics import span

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C signature of each kind of entry, before (dt, rk4_steps, params, stream).
_ARGS = {
    "cuda_entry": [_P] * 6 + [_I] * 5,  # vde_<model>
    "cuda_rk4_entry": [_P, _L, _P, _L, _L, _P, _L, _P] + [_I] * 6,  # rk4_<model>
}


WARP = 32
REGS_SM = 65536  # 32-bit registers of one H100 SM
THREADS_SM = 2048  # resident threads of one SM at most
MAX_REGS = 255  # registers of one thread at most


class VdeGeometry(NamedTuple):
    """A team functor's launch of ``vde_kernel``."""

    team: int  # lanes per (b, k) row (ROW_TEAM)
    cols: int  # tangent columns per lane
    rows_per_block: int
    threads: int  # per block: ROW_WARPS warps, the kernel's launch bound
    grid: int  # blocks
    shared_bytes: int  # dynamic: the block's rows of A, Bm and c, then the table or p rows
    table_bytes: int  # of the functor's table in shared_bytes
    block_bytes: int  # dynamic and static shared bytes of a block
    max_registers: int  # per thread, as the launch bounds cap them
    rows_bytes: int  # of the block's scenarios' p rows in shared_bytes


def rows_staged(N):
    """Whether the kernels stage a routed functor's p rows in shared memory
    (``csrc/vde.cuh:rows_staged``): where each scenario owns N > 1 rows."""
    return N > 1


def block_scenarios(rows_per_block, N, batch):
    """The most scenarios whose p rows a block of ``rows_per_block``
    consecutive (b, k) rows reads at horizon N
    (``csrc/vde.cuh:block_scenarios``)."""
    return min((rows_per_block - 1) // N + 2, batch)


def vde_geometry(batch, N, nx, nu, team, row_warps, min_blocks=1, static_bytes=0,
                 table_bytes=0, row_floats=0):
    """The launch of a team functor's sweep: ``team`` consecutive lanes of a
    warp per (b, k) row, thread t of a block on row t // team of its
    ``rows_per_block`` and on tangent columns [cols (t % team), cols (t %
    team + 1)) of [A | Bm]; ``row_warps`` warps per block; the block's tile
    of its rows' outputs in dynamic shared memory, then ``table_bytes`` of
    the functor's table, or, for a functor that reads ``row_floats`` p
    entries per scenario from shared memory (a routed GP), the p rows of
    the block's scenarios where :func:`rows_staged`; registers capped so
    that ``min_blocks`` blocks fit an SM (``__launch_bounds__``). A team of
    1 is the thread-per-row path: a thread per row, every column, the
    block's warps' tiles in one. Raises for a team that does not divide a
    warp, a block whose rows do not start on 16 bytes in every output, or
    a block or an SM's ``min_blocks`` that does not fit the shared memory
    or the threads."""
    nv = nx + nu
    if team < 1 or WARP % team:
        raise ValueError(f"VDE: a team of {team} lanes does not divide a warp")
    cols = -(-nv // team)
    threads = row_warps * WARP
    rows_per_block = threads // team
    if rows_per_block % 4:
        raise ValueError(f"VDE: {rows_per_block} rows per block do not start "
                         "on 16 bytes in c")
    rows = 4 * row_floats * block_scenarios(rows_per_block, N, batch) if rows_staged(N) else 0
    shared = 4 * rows_per_block * nx * (nv + 1) + table_bytes + rows
    block = shared + static_bytes
    if (block > SMEM_BLOCK_MAX or min_blocks * threads > THREADS_SM
            or min_blocks * (block + SMEM_BLOCK_RESERVED) > SMEM_SM):
        raise ValueError(f"VDE: {min_blocks} blocks of {threads} threads and "
                         f"{block} shared bytes do not fit an SM")
    units = REGS_SM // (min_blocks * row_warps * 256)  # of 256 registers a warp
    return VdeGeometry(team, cols, rows_per_block, threads,
                       -(-batch * N // rows_per_block), shared, table_bytes, block,
                       min(MAX_REGS, 8 * units), rows)


def lane_work(geo, rows, nv, block, thread):
    """What thread ``thread`` of block ``block`` computes in ``geo`` over
    ``rows`` rows of ``nv`` tangent columns: (its row, its columns, whether
    it writes the row's c, whether its block stores the row). The last
    block's threads past ``rows`` compute the last row again and store
    nothing; a lane's columns past ``nv`` are computed and not stored."""
    rank = thread % geo.team
    row = block * geo.rows_per_block + thread // geo.team
    cols = range(geo.cols * rank, min(geo.cols * (rank + 1), nv))
    return min(row, rows - 1), cols, rank == 0, row < rows


def _entry_name(f, kind="cuda_entry"):
    """The C entry of ``csrc/<f.cuda_source>.cu`` that runs a kernel with
    the functor of the dynamics ``f`` (its ``cuda_entry`` or
    ``cuda_rk4_entry``)."""
    name = getattr(f, kind, None)
    if name is None:
        raise NotImplementedError(f"no CUDA functor in csrc/ for dynamics {f!r}")
    return name


def _lib(source, defines=()):
    """The loaded ``csrc/<source>.cu``; at first load the kernels of a
    functor with a table in dynamic shared memory are allowed the largest
    table (``vde_prepare``), so that no launch sets an attribute and a
    launch may be captured in a CUDA graph."""
    lib = _build.load(source, defines)
    if not getattr(lib, "_prepared", False):
        lib.vde_prepare.argtypes = []
        lib.vde_prepare.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        err = lib.vde_prepare()
        if err:
            raise RuntimeError(f"vde_prepare: {lib.error_string(err).decode()}")
        lib._prepared = True
    return lib


def _entry(f, kind="cuda_entry", defines=()):
    """(C entry of ``f``, ``error_string``), the entry typed for the
    parameter struct that ``f.cuda_params()`` builds. ``defines`` build
    ``f``'s source with those ``-D`` macros (its functors' traits)."""
    lib = _lib(f.cuda_source, defines)
    fn = getattr(lib, _entry_name(f, kind))
    if fn.argtypes is None:
        geometry = [_I] * 3 if kind == "cuda_entry" and _is_team(f) else []
        fn.argtypes = _ARGS[kind] + geometry + [ctypes.c_double, _I,
                                                type(f.cuda_params()), _P]
        fn.restype = ctypes.c_int
    return fn, lib.error_string


def _is_team(f):
    """Whether ``f``'s sweep runs the team path (its entry takes the
    geometry)."""
    return getattr(f, "cuda_team", False)


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
        self._team = {}

    def team_traits(self):
        """A team functor's {"team", "row_warps", "min_blocks", "cols",
        "static_bytes", "registers"} as its library was built with this
        sweep's ``defines`` (``vde_<model>_traits``)."""
        key = ("traits", self.defines)
        if key not in self._team:
            lib = _lib(self.f.cuda_source, self.defines)
            fn = getattr(lib, f"{_entry_name(self.f)}_traits")
            fn.argtypes, fn.restype = [ctypes.POINTER(_I)], _I
            out = (_I * 6)()
            if err := fn(out):
                raise RuntimeError(f"{fn.__name__}: {lib.error_string(err).decode()}")
            self._team[key] = dict(zip(("team", "row_warps", "min_blocks", "cols",
                                        "static_bytes", "registers"), out))
        return self._team[key]

    def geometry(self, batch, N=None):
        """The team path's :func:`vde_geometry` at ``batch`` scenarios of
        ``N`` stages (the sweep's horizon by default), with the table of a
        functor that stages one (its dynamics' ``cuda_table``) or the p rows
        of one that reads them from shared memory (``cuda_rows``)."""
        key = (self.defines, batch, self.N if N is None else N)
        if key not in self._team:
            t = self.team_traits()
            table = getattr(self.f, "cuda_table", None)
            self._team[key] = vde_geometry(
                batch, key[2], self.nx, self.nu, t["team"], t["row_warps"],
                t["min_blocks"], t["static_bytes"], 4 * table().size if table else 0,
                self.p_dim if getattr(self.f, "cuda_rows", False) else 0)
        return self._team[key]

    def occupancy(self, batch, N=None):
        """Blocks of the team path's :meth:`geometry` resident on one SM of
        the current device (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
        geo = self.geometry(batch, N)
        lib = _lib(self.f.cuda_source, self.defines)
        fn = getattr(lib, f"{_entry_name(self.f)}_occupancy")
        fn.argtypes, fn.restype = [_I, _I], _I
        n = fn(geo.threads, geo.shared_bytes)
        if n < 0:
            raise RuntimeError(f"{fn.__name__}: {lib.error_string(-n).decode()}")
        return n

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
        with span("launch.vde"):
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
            geometry = ()
            if _is_team(self.f):
                geo = self.geometry(B, N)
                geometry = (geo.grid, geo.threads, geo.shared_bytes)
            _run(fn, error_string, self.f, xs.device, xs.data_ptr(), us.data_ptr(),
                 ps.data_ptr(), A.data_ptr(), Bm.data_ptr(), c.data_ptr(), B, N,
                 nx, nu, ps.shape[-1], *geometry, self.dt, self.rk4_steps)
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
        with span("launch.rk4"):
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
