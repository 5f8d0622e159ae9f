"""Fused interior-point LQ-QP solve: CUDA kernel wrapper and plain version.

Replaces ``ad_mpc_tpu/ops/pallas_lq.py:_lq_kernel_rolled`` and its
stage-unrolled twin ``_lq_kernel`` (built by ``make_lq_solver``; the
Pallas wrapper takes it for N < 16, as at the quad's N=10). The kernels
are ``csrc/lq_ipm.cu`` (7x2: a team of 8 lanes per scenario, lane i on
row i) and ``csrc/lq_ipm_wide.cuh`` (13x4: a team of 16 lanes per
scenario, each on a 4x4 tile of the stage's 16x16 products), one for each
shape in :data:`SHAPES`, S teams to a block, with the whole iterate in
shared memory. :func:`lq_geometry` picks S and the shared bytes per
scenario here, so that the CPU tests reach it; the kernel checks them
against its own layout.

Pallas baked the bounds into the trace as Python constants; here they are a
by-value list of the active (finite) cone entries, and buffers of the module
for the plain version. The plain version, :func:`lq_plain`, is the batched
:func:`ad_mpc_tpu_torch.ops.qp_ipm.solve_lq_ocp`. The wrapper runs it only
for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ad_mpc_tpu_torch.ops import _build
from ad_mpc_tpu_torch.ops.qp_ipm import BoundSpec, solve_lq_ocp
from ad_mpc_tpu_torch.ops.riccati import lqr_solve

MAX_CONES = 32  # LQ_MAX_CONES in csrc/lq_ipm.cu
SHAPES = ((7, 2), (13, 4))  # (nx, nu) of the kernels
MAX_TEAMS = 8  # scenarios per block at most (LQ_MAX_TEAMS, lq_wide::MAX_TEAMS)
WIDE = 16  # padded row width and team lanes of the 13x4 kernel (lq_wide::W)
SMEM_BLOCK_MAX = 232448  # bytes of shared memory an H100 block may use
SMEM_SM = 233472  # bytes of shared memory on one H100 SM
SMEM_BLOCK_RESERVED = 1024  # bytes the system keeps for each resident block
MAX_BLOCKS_SM = 32  # resident blocks on one SM at most
SMS = 132  # streaming multiprocessors of an H100 SXM


def _align4(n):
    return (n + 3) & ~3


def team_lanes(nx):
    """Lanes of the team that runs one scenario (``lq_team`` in
    csrc/lq_ipm.cu): 8, one per state row, 4 teams to a warp, up to nx=8;
    16, one per 4x4 tile of a 16x16 product, 2 teams to a warp, above."""
    return 8 if nx <= 8 else WIDE


def header_floats(nx, nu):
    """Shared floats of a block's header: Q, QN (at 13x4 padded to 16x16),
    R and the cone list."""
    w = WIDE if nx > 8 else nx
    return (2 * w * w + nu * nu + 7 * MAX_CONES + 31) & ~31


def scenario_floats(N, nx, nu, nc):
    """Shared floats of one scenario (``Layout`` in csrc/lq_ipm.cu and
    ``lq_wide::Layout`` in csrc/lq_ipm_wide.cuh, which reject a smaller
    pitch): the iterate and the Newton step, the gains K and kf of every
    stage, the cone variables and the references under the cones, two stage
    buffers, the team's tiles and a ring of 8 or 16 stages' cone weights
    and gradients, padded to the team's width mod 32 floats so that the
    teams of a warp start on different banks. At 13x4 the state rows, A's
    rows and the tiles are 16 wide, and q and r stay resident."""
    team = team_lanes(nx)
    ring = 2 * team * max(nc, 1)
    if nx > 8:
        W = WIDE
        nst = _align4(W * (N + 1) + nu * N)
        tiles = 2 * W * W + 2 * nu * W + nu * nu + 2 * W + _align4(nu)
        stage = nx * W + nx * nu
        raw = (2 * nst + N * nu * W + _align4(4 * nc * N) + _align4(nc * N)
               + _align4(nx * (N + 1) + nu * N) + ring + tiles
               + 2 * stage)
        return raw + (team - raw) % 32
    nst = _align4((N + 1) * nx + N * nu)
    gain = _align4(nu * nx + nu)
    stage = _align4(nx * nx) + _align4(nx * nu) + 2 * _align4(nx) + _align4(nu)
    tile = _align4(nx * nx) + _align4(nx * nu) + _align4(nx)
    raw = (2 * nst + N * gain + _align4(4 * nc * N) + _align4(nc * N)
           + 2 * stage + tile + ring)
    return raw + (team - raw) % 32


class Geometry(NamedTuple):
    teams: int  # S, scenarios per block
    threads: int  # per block
    pitch: int  # shared floats per scenario
    block_bytes: int  # shared bytes per block

    def blocks(self, batch):
        return -(-batch // self.teams)


def lq_geometry(N, nx, nu, nc, teams=None, batch=None):
    """The launch geometry: the number of scenarios per block, at most
    ``MAX_TEAMS``, that keeps the most scenarios resident on an SM by shared
    memory (these set the kernel's rate), the larger on a tie; or ``teams``
    scenarios per block when given. Teams of 16 lanes (13x4) fill whole
    warps: with an odd number of them a block's last warp issues for one
    team at full cost. At 13x4, given the ``batch``, the number with the
    least time by a model in which an SM works through the scenarios dealt
    to it (blocks dealt round-robin to ``SMS`` SMs) at a rate that grows
    with the scenarios it holds at once, then the fewest scenarios on the
    busiest SM, then the larger (PERF.md, ``experiments/quad_kernels.py``:
    blocks of more than 8 scenarios, one to an SM, ran slower)."""
    team = team_lanes(nx)
    pitch = scenario_floats(N, nx, nu, nc)
    nbytes = lambda s: 4 * (header_floats(nx, nu) + s * pitch)
    fits = [s for s in range(1, MAX_TEAMS + 1) if nbytes(s) <= SMEM_BLOCK_MAX]
    if not fits or (teams is not None and teams not in fits):
        raise ValueError(f"LQ kernel: {teams or 1} scenarios (N={N}, {nc} "
                         f"cones) need {nbytes(teams or 1)} bytes of shared "
                         "memory, or more than a block holds")
    resident = lambda s: s * min(MAX_BLOCKS_SM,
                                 SMEM_SM // (nbytes(s) + SMEM_BLOCK_RESERVED))
    if teams is None:
        whole = [s for s in fits if team * s % 32 == 0] if team == 16 else []
        teams = max(whole or fits, key=lambda s: (resident(s), s))
        if batch and whole:
            def cost(s):
                blocks = -(-batch // s)
                load = s * -(-blocks // SMS)  # scenarios on the busiest SM
                return load / min(resident(s), load), load, -s

            teams = min(whole, key=cost)
    return Geometry(teams, team * teams, pitch, nbytes(teams))


class _LqCone(ctypes.Structure):
    _fields_ = [("is_x", ctypes.c_int), ("j", ctypes.c_int),
                ("lo", ctypes.c_int), ("soft", ctypes.c_int),
                ("b", ctypes.c_float), ("z", ctypes.c_float),
                ("Z", ctypes.c_float)]


class _LqBounds(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("e", _LqCone * MAX_CONES)]


def _lib():
    """The loaded kernels, typed; at first load each kernel is allowed a
    block's whole shared memory on the current device (``lq_ipm_prepare``),
    so that no launch sets an attribute and a launch may be captured in a
    CUDA graph."""
    lib = _build.load("lq_ipm")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lq_ipm.argtypes = [P] * 13 + [I] * 5 + [F, F, _LqBounds, I, I, P]
        lib.lq_ipm.restype = I
        lib.lq_ipm_occupancy.argtypes = [I] * 6
        lib.lq_ipm_occupancy.restype = I
        lib.lq_ipm_scenario_floats.argtypes = [I] * 4
        lib.lq_ipm_scenario_floats.restype = I
        lib.lq_ipm_prepare.argtypes = []
        lib.lq_ipm_prepare.restype = I
        lib.error_string.argtypes = [I]
        lib.error_string.restype = ctypes.c_char_p
        err = lib.lq_ipm_prepare()
        if err:
            raise RuntimeError(f"lq_ipm_prepare: {lib.error_string(err).decode()}")
        lib._typed = True
    return lib


def cone_entries(u_bounds, x_bounds):
    """Active cone entries (is_x, j, lo, soft, b, z, Z) in the order u_lo,
    u_hi, x_lo, x_hi, each by ascending index — the order of the Pallas
    kernel's sides. Only finite bounds get an entry."""
    out = []
    for is_x, bd in ((0, u_bounds), (1, x_bounds)):
        for lo in (True, False):
            b = np.asarray(bd["lb"] if lo else bd["ub"], np.float64)
            z = np.asarray(bd["zl"] if lo else bd["zu"], np.float64)
            Z = np.asarray(bd["Zl"] if lo else bd["Zu"], np.float64)
            soft = np.asarray(bd["soft"], bool)
            for j in np.flatnonzero(np.isfinite(b)):
                out.append((is_x, int(j), int(lo), int(soft[j]),
                            float(b[j]), float(z[j]), float(Z[j])))
    return out


def lq_plain(A, Bm, c, q, r, u_ref, x_ref, Q, R, QN, u_spec, x_spec,
             iters, reg=1e-8, tau_min=1e-8, lqr_fn=lqr_solve):
    """Plain PyTorch version: the batched IPM with the same stage weights
    and bounds (:class:`BoundSpec`). Returns (dx (B,N+1,nx), du (B,N,nu),
    alpha (B,)). ``lqr_fn`` is the IPM's Riccati solve (the kernel runs the
    sequential one)."""
    N, nx, nu = A.shape[1], A.shape[-1], Bm.shape[-1]
    Qs = torch.cat([Q.expand(N, nx, nx), QN[None]], dim=0)
    Rs = R.expand(N, nu, nu)
    dx, du, stats = solve_lq_ocp(
        A, Bm, c, Qs, q, Rs, r, A.new_zeros((A.shape[0], nx)),
        u_spec, x_spec, u_ref=u_ref, x_ref=x_ref,
        iters=iters, reg=reg, tau_min=tau_min, lqr_fn=lqr_fn,
    )
    alpha = stats["alpha"][-1] if iters else A.new_ones(A.shape[0])
    return dx, du, alpha


class LQSolver(nn.Module):
    """Batched box-constrained LQ OCP solver with fixed IPM iterations.

    ``forward(A, Bm, c, q, r, u_ref, x_ref)`` takes batch-first float32
    tensors (B,N,nx,nx), (B,N,nx,nu), (B,N,nx), (B,N+1,nx), (B,N,nu),
    (B,N,nu), (B,N+1,nx) and returns (dx (B,N+1,nx), du (B,N,nu),
    alpha (B,)). ``launches`` counts kernel launches; ``geometry`` is
    the kernel's launch geometry, with ``teams`` scenarios per block when
    that is set (:func:`lq_geometry` picks them when it is None).
    """

    def __init__(self, N, nx, nu, Q, R, QN, u_bounds, x_bounds, iters=12,
                 reg=1e-8, tau_min=1e-8):
        super().__init__()
        self.N, self.nx, self.nu = N, nx, nu
        self.iters, self.reg, self.tau_min = iters, float(reg), float(tau_min)
        # The kernel reads float32 weights; the plain version keeps them in
        # float64 and rounds them to its inputs' dtype.
        as_t = lambda m, dt: torch.as_tensor(np.asarray(m, dt))
        for name, m in (("Q", Q), ("R", R), ("QN", QN)):
            self.register_buffer(name, as_t(m, np.float32))
            self.register_buffer(f"{name}64", as_t(m, np.float64))
        for g, bd in (("u", u_bounds), ("x", x_bounds)):
            for k in BoundSpec._fields:
                self.register_buffer(f"{g}_{k}", as_t(
                    bd[k], bool if k == "soft" else np.float64))
        cones = cone_entries(u_bounds, x_bounds)
        if len(cones) > MAX_CONES:
            raise ValueError(f"{len(cones)} bound entries > {MAX_CONES}")
        self._bounds = _LqBounds(len(cones), (_LqCone * MAX_CONES)(
            *(_LqCone(*e) for e in cones)))
        self.teams = None
        self.launches = 0

    def plain(self, A, Bm, c, q, r, u_ref, x_ref, lqr_fn=lqr_solve):
        """:func:`lq_plain` with this solver's weights and bounds, in the
        inputs' dtype and on their device."""
        f = lambda t: t.to(A.device, t.dtype if t.dtype == torch.bool else A.dtype)
        spec = lambda g: BoundSpec(*(f(getattr(self, f"{g}_{k}"))
                                     for k in BoundSpec._fields))
        return lq_plain(A, Bm, c, q, r, u_ref, x_ref, f(self.Q64), f(self.R64),
                        f(self.QN64), spec("u"), spec("x"), self.iters,
                        self.reg, self.tau_min, lqr_fn)

    @property
    def geometry(self):
        """The kernel's launch geometry with no batch given
        (:func:`lq_geometry`)."""
        return self.geometry_for(None)

    def geometry_for(self, batch):
        """The launch geometry of a batch of ``batch`` scenarios."""
        return lq_geometry(self.N, self.nx, self.nu, self._bounds.n, self.teams,
                           batch)

    def occupancy(self, batch=None):
        """Blocks of the geometry of ``batch`` resident on one SM of the
        card, by ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
        lib, geo = _lib(), self.geometry_for(batch)
        n = lib.lq_ipm_occupancy(self.N, self.nx, self.nu, self._bounds.n,
                                 geo.teams, geo.pitch)
        if n < 0:
            raise RuntimeError(f"lq_ipm_occupancy: {lib.error_string(-n).decode()}")
        return n

    def forward(self, A, Bm, c, q, r, u_ref, x_ref):
        if A.device.type == "cpu":
            return self.plain(A, Bm, c, q, r, u_ref, x_ref)
        if A.device.type != "cuda":
            raise ValueError(f"LQSolver: unsupported device {A.device}")
        return self._launch(A, Bm, c, q, r, u_ref, x_ref)

    def _launch(self, A, Bm, c, q, r, u_ref, x_ref):
        B, N, nx, nu = A.shape[0], self.N, self.nx, self.nu
        if (nx, nu) not in SHAPES:
            raise NotImplementedError(f"LQ kernel: nx={nx}, nu={nu} is not "
                                      f"one of its shapes {SHAPES}")
        args = (("A", A, (B, N, nx, nx)), ("Bm", Bm, (B, N, nx, nu)),
                ("c", c, (B, N, nx)), ("q", q, (B, N + 1, nx)),
                ("r", r, (B, N, nu)), ("u_ref", u_ref, (B, N, nu)),
                ("x_ref", x_ref, (B, N + 1, nx)))
        for name, t, shape in args:
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"LQSolver: {name} must be contiguous float32")
            if t.device != A.device or tuple(t.shape) != shape:
                raise ValueError(f"LQSolver: {name} {tuple(t.shape)} on "
                                 f"{t.device}, expected {shape} on {A.device}")
        if self.Q.device != A.device:
            raise ValueError(f"LQSolver weights on {self.Q.device}, "
                             f"inputs on {A.device}")
        geo, dev = self.geometry_for(B), A.device  # refuses a horizon that does not fit
        lib = _lib()
        dx = torch.empty((B, N + 1, nx), dtype=torch.float32, device=dev)
        du = torch.empty((B, N, nu), dtype=torch.float32, device=dev)
        alpha = torch.empty((B,), dtype=torch.float32, device=dev)
        err = lib.lq_ipm(
            A.data_ptr(), Bm.data_ptr(), c.data_ptr(), q.data_ptr(),
            r.data_ptr(), u_ref.data_ptr(), x_ref.data_ptr(),
            self.Q.data_ptr(), self.R.data_ptr(), self.QN.data_ptr(),
            dx.data_ptr(), du.data_ptr(), alpha.data_ptr(),
            B, N, nx, nu, self.iters, self.reg, self.tau_min, self._bounds,
            geo.teams, geo.pitch, torch.cuda.current_stream(dev).cuda_stream,
        )
        if err:
            raise RuntimeError(f"lq_ipm: {lib.error_string(err).decode()}")
        self.launches += 1
        return dx, du, alpha


def make_lq_solver(N, nx, nu, Q, R, QN, u_bounds, x_bounds, iters=12,
                   reg=1e-8, tau_min=1e-8, device="cuda"):
    """Build the batched QP solver for ``device``.

    Q/R/QN: (nx,nx)/(nu,nu)/(nx,nx) stage weights; u_bounds/x_bounds: numpy
    dicts with the fields of :class:`BoundSpec`. On a CUDA
    device the kernel is built now.
    """
    if torch.device(device).type == "cuda":
        _build.require_card(device)
        _lib()
    return LQSolver(N, nx, nu, Q, R, QN, u_bounds, x_bounds, iters=iters,
                    reg=reg, tau_min=tau_min).to(device)
