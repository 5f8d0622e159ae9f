"""SQP-RTI nonlinear MPC solvers (port of ``ad_mpc_tpu/ocp/solver.py``).

:class:`BatchedSQPSolver` solves a fleet; :class:`SQPSolver` solves one
vehicle, with per-stage parameters and the full-SQP merit line search.
Each solve runs ``spec.sqp_iters`` Gauss-Newton iterations. With
``backend="cuda"`` one iteration is two kernel launches:

- the fused RK4 + forward-sensitivity sweep (``ops/cuda_vde.py:VDE``);
- the fused fixed-iteration interior-point QP (``ops/cuda_lq.py``);

and the KKT defect of the returned iterate and :meth:`BatchedSQPSolver.F`
(the fleet's plant step) are one launch each of the sweep's tangent-free
RK4 kernel (``ops/cuda_vde.py:RK4``). The single vehicle's line search
rolls its candidates out through the same RK4 kernel, all candidates in
one launch per stage.

``backend="plain"`` runs their plain PyTorch versions instead, on any
device; it is the counterpart of the JAX package's ``backend='xla'`` and
the only backend that takes ``spec.assoc_riccati`` (the LQ kernel runs the
sequential recursion) or float64 (the kernels run float32). ``"auto"``
picks ``"cuda"`` on a CUDA device and ``"plain"`` on the CPU. The RTI warm
start is an explicit :class:`SolverState` threaded through solves and
shifted.

Not in this slice: the multi-device ``mesh``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from ad_mpc_tpu_torch.ocp.spec import OCPSpec
from ad_mpc_tpu_torch.ops import _build
from ad_mpc_tpu_torch.ops.assoc_riccati import lqr_solve_assoc
from ad_mpc_tpu_torch.ops.cuda_lq import make_lq_solver
from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4, make_vde
from ad_mpc_tpu_torch.ops.riccati import lqr_solve
from ad_mpc_tpu_torch.utils.math import yaw_wrap_reference

BACKENDS = ("auto", "cuda", "plain")


def resolve_backend(backend: str, device) -> str:
    """``"auto"`` -> ``"cuda"`` on a CUDA device, ``"plain"`` on the CPU."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "plain"
    return backend


def _lqr_fn(spec: OCPSpec, backend: str):
    """The IPM's Riccati solve: sequential, or the associative scan when
    ``spec.assoc_riccati``. The LQ kernel has only the sequential one, so
    the cuda backend refuses the associative scan rather than ignore it."""
    if not spec.assoc_riccati:
        return lqr_solve
    if backend == "cuda":
        raise NotImplementedError(
            "assoc_riccati=True needs backend='plain': the LQ kernel runs the "
            "sequential Riccati recursion")
    return lqr_solve_assoc


class SolverState(NamedTuple):
    """RTI warm-start iterate: xs (B, N+1, nx), us (B, N, nu) for the fleet
    solver; xs (N+1, nx), us (N, nu) for the single vehicle."""

    xs: torch.Tensor
    us: torch.Tensor


class SolveResult(NamedTuple):
    us: torch.Tensor  # (B, N, nu) or (N, nu) optimized controls
    xs: torch.Tensor  # (B, N+1, nx) or (N+1, nx) optimized states
    state: SolverState  # warm start for the next solve
    kkt_residual: torch.Tensor  # (B,) or () RMS dynamics defect of the iterate
    alpha: torch.Tensor  # (B,) or () last-QP step sizes (diagnostics)


def save_iterate(path: str, state: SolverState) -> str:
    """Persist a warm-start iterate as npz (the JAX package's format)."""
    np.savez(path, xs=state.xs.detach().cpu().numpy(),
             us=state.us.detach().cpu().numpy())
    return path


def load_iterate(path: str, device="cuda") -> SolverState:
    """Restore an iterate written by either package's ``save_iterate``."""
    with np.load(path) as z:
        return SolverState(xs=torch.as_tensor(z["xs"], device=device),
                           us=torch.as_tensor(z["us"], device=device))


class _GaussNewton(nn.Module):
    """What both solvers share: the backend, the three kernels or their
    plain versions, the stage weights, and one Gauss-Newton step's QP on
    batch-first tensors."""

    def __init__(self, spec: OCPSpec, dynamics: Callable, p_dim: int,
                 device, backend: str, dtype=torch.float32):
        super().__init__()
        backend = resolve_backend(backend, device)
        self.lqr_fn = _lqr_fn(spec, backend)
        if backend == "cuda" and torch.device(device).type != "cuda":
            raise ValueError("backend='cuda' launches the CUDA kernels; "
                             f"device={device!r} is not a CUDA device")
        if backend == "cuda" and dtype != torch.float32:
            raise ValueError(f"backend='cuda' runs float32 kernels; dtype={dtype} "
                             "needs backend='plain'")
        _build.require_card(device)
        self.spec, self.p_dim, self.backend, self.dtype = spec, p_dim, backend, dtype
        self.f = dynamics
        N, nx, nu = spec.n_nodes, spec.nx, spec.nu
        Q, R, QN = spec.weight_arrays()
        u_bounds, x_bounds = spec.bound_dicts()
        self.register_buffer("Q", torch.as_tensor(Q, dtype=dtype))
        self.register_buffer("R", torch.as_tensor(R, dtype=dtype))
        self.register_buffer("QN", torch.as_tensor(QN, dtype=dtype))
        # The plain backend builds no kernel: the wrappers are made on the
        # CPU and only their plain versions are called.
        build_on = device if backend == "cuda" else "cpu"
        self.vde = make_vde(dynamics, spec.dt, N, nx, nu, p_dim,
                            rk4_steps=spec.rk4_steps, device=build_on)
        self.rk4 = make_rk4(dynamics, spec.dt, nx, nu, p_dim,
                            rk4_steps=spec.rk4_steps, device=build_on)
        self.qp = make_lq_solver(N, nx, nu, Q, R, QN, u_bounds, x_bounds,
                                 iters=spec.qp_iters, reg=spec.levenberg,
                                 device=build_on)

    def _check_tf32(self, x0):
        if (x0.device.type == "cuda" and self.spec.matmul_precision == "highest"
                and torch.backends.cuda.matmul.allow_tf32):
            raise RuntimeError("matmul_precision='highest' needs "
                               "torch.backends.cuda.matmul.allow_tf32 = False")

    def F(self, x, u, p):
        """Discrete dynamics on batch-first tensors. The cuda backend takes
        x (M, nx), u (M, nu), p (M, p_dim) (``ops/cuda_vde.py:RK4``); the plain
        backend broadcasts leading axes (``integrators.discrete_step``)."""
        if self.backend == "cuda":
            return self.rk4(x, u, p)
        return self.rk4.plain(x, u, p)

    def _sweep(self, xs, us, ps):
        """(A, Bm, c) of the batch xs (B,N+1,nx), us (B,N,nu), ps (B,p_dim)."""
        if self.backend == "cuda":
            return self.vde(xs, us, ps)
        return self.vde.plain(xs, us, ps)

    def _defect(self, xs, us, ps):
        """F(x_k, u_k) - x_{k+1} of the batch, (B, N, nx)."""
        if self.backend == "cuda":
            return self.rk4.defect(xs, us, ps)
        return self.rk4.defect_plain(xs, us, ps)

    def _qp_step(self, xs, us, A, Bm, c, yref_x, yref_u):
        """The Gauss-Newton step (dx, du, alpha) of the batch: the LQ
        subproblem's gradients at the iterate, then the QP."""
        q_lin = torch.einsum("ij,bkj->bki", self.Q, xs[:, :-1] - yref_x[:, :-1])
        q_term = torch.einsum("ij,bj->bi", self.QN, xs[:, -1] - yref_x[:, -1])
        q = torch.cat([q_lin, q_term[:, None]], dim=1).contiguous()
        r = torch.einsum("ij,bkj->bki", self.R, us - yref_u).contiguous()
        if self.backend == "cuda":
            return self.qp(A, Bm, c, q, r, us, xs)
        return self.qp.plain(A, Bm, c, q, r, us, xs, lqr_fn=self.lqr_fn)


class BatchedSQPSolver(_GaussNewton):
    """Fleet-scale SQP-RTI solver.

    :param dynamics: continuous ``f(x, u, p) -> x_dot`` on entries-leading
        tensors (``x[i]`` is one state entry) with a per-scenario parameter
        vector of ``p_dim`` entries, e.g.
        :class:`ad_mpc_tpu_torch.models.bicycle.BicycleDynamics` (1) or
        :class:`ad_mpc_tpu_torch.models.quadrotor.QuadDynamics` (0: params
        of shape (B, 0), which the kernels never read).
    :param backend: ``"cuda"`` (the kernels), ``"plain"`` (their plain
        versions) or ``"auto"`` (see :func:`resolve_backend`).
    """

    def __init__(self, spec: OCPSpec, dynamics: Callable, p_dim: int,
                 device="cuda", backend: str = "auto"):
        super().__init__(spec, dynamics, p_dim, device, backend)
        self.to(device)

    @torch.no_grad()
    def solve(self, x0, yref_x, yref_u, params, state: SolverState) -> SolveResult:
        """Batched solve. x0 (B,nx), yref_x (B,N+1,nx), yref_u (B,N,nu),
        params (B,p_dim), state batched likewise."""
        spec = self.spec
        self._check_tf32(x0)
        f32 = torch.float32
        x0, yref_x, yref_u = x0.to(f32), yref_x.to(f32), yref_u.to(f32)
        params = params.to(f32).contiguous()
        xs, us = state.xs.to(f32), state.us.to(f32)
        if spec.yaw_wrap_idx is not None:
            i = spec.yaw_wrap_idx
            yref_x = yref_x.clone()
            yref_x[:, :, i] = yaw_wrap_reference(yref_x[:, :, i], x0[:, i, None])

        alpha = None
        for _ in range(spec.sqp_iters):
            xs = xs.clone()
            xs[:, 0] = x0
            us = us.contiguous()
            A, Bm, c = self._sweep(xs, us, params)
            dx, du, alpha = self._qp_step(xs, us, A, Bm, c, yref_x, yref_u)
            xs, us = xs + dx, us + du

        defect = self._defect(xs, us, params)
        kkt = torch.sqrt(torch.mean(defect**2, dim=(1, 2)))
        return SolveResult(us=us, xs=xs, state=SolverState(xs, us),
                           kkt_residual=kkt, alpha=alpha)

    @staticmethod
    def shift(state: SolverState) -> SolverState:
        """RTI shift: advance the warm start one stage."""
        xs = torch.cat([state.xs[:, 1:], state.xs[:, -1:]], dim=1)
        us = torch.cat([state.us[:, 1:], state.us[:, -1:]], dim=1)
        return SolverState(xs=xs, us=us)

    def init_state(self, x0s) -> SolverState:
        """Cold start for a (B, nx) batch: constant-state warm start."""
        x0s = torch.as_tensor(x0s, dtype=torch.float32, device=self.Q.device)
        N = self.spec.n_nodes
        xs = x0s[:, None].expand(-1, N + 1, -1).contiguous()
        us = x0s.new_zeros((x0s.shape[0], N, self.spec.nu))
        return SolverState(xs=xs, us=us)


class SQPSolver(_GaussNewton):
    """Single-vehicle SQP solver (port of ``ad_mpc_tpu/ocp/solver.py:83-295``).

    :param dynamics: continuous ``f(x, u, p) -> x_dot`` as for
        :class:`BatchedSQPSolver`; ``params`` of a solve are (p_dim,),
        broadcast to every stage, or (N, p_dim), a row per stage (the
        ACADOS per-stage ``p``).
    :param dtype: float32; float64 only on the plain backend.

    A solve is ``spec.sqp_iters`` Gauss-Newton iterations, each on the
    cuda backend one VDE launch and one LQ launch at B=1: with per-stage
    parameters the sweep runs as N one-stage scenarios, (x_k, x_{k+1}) with
    p_k each. With ``spec.ls_steps > 1`` each iteration ranks the
    candidates ``us + 0.5^j du`` by the exact merit after rolling them out
    through the dynamics (``ls_steps`` rows per RK4 launch, N launches)
    and keeps the best, picked on the device. The KKT defect of the
    returned iterate is one RK4 launch. Nothing in a solve waits for the
    card.
    """

    def __init__(self, spec: OCPSpec, dynamics: Callable, p_dim: int = 0,
                 dtype=torch.float32, device="cuda", backend: str = "auto"):
        super().__init__(spec, dynamics, p_dim, device, backend, dtype)
        u_bounds, x_bounds = spec.bound_dicts()
        as_t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt)
        for g, bd in (("u", u_bounds), ("x", x_bounds)):
            for k in ("lb", "ub", "zl", "zu", "Zl", "Zu"):
                self.register_buffer(f"{g}_{k}", as_t(bd[k]))
        self.register_buffer("u_soft", as_t(u_bounds["soft"]))
        self.register_buffer("ls_alphas", 0.5 ** torch.arange(
            spec.ls_steps, dtype=dtype))
        self.to(device)

    @staticmethod
    def _as_batch(xs, us, params):
        """One vehicle as the kernels' batch: B=1 for a broadcast p, or N
        one-stage scenarios (x_k, x_{k+1}; u_k; p_k) for per-stage p. Each
        thread of a kernel computes one (scenario, stage), so both give the
        same stages."""
        if params.ndim == 1:
            return xs[None], us[None], params[None]
        return (torch.stack([xs[:-1], xs[1:]], dim=1), us[:, None],
                params.contiguous())

    def _linearize(self, xs, us, params):
        """(A (N,nx,nx), Bm (N,nx,nu), c (N,nx)) of one vehicle."""
        return tuple(t.reshape(-1, *t.shape[2:])
                     for t in self._sweep(*self._as_batch(xs, us, params)))

    def _rollout(self, x0, us, ps):
        """Roll L control sequences us (L, N, nu) out from x0 with per-stage
        parameters ps (N, p_dim): one RK4 call per stage -> (L, N+1, nx)."""
        L = us.shape[0]
        x = x0.expand(L, -1)
        xs = [x]
        for k in range(us.shape[1]):
            x = self.F(x, us[:, k], ps[k].expand(L, -1))
            xs.append(x)
        return torch.stack(xs, dim=1)

    def _merit(self, xs_c, us_c, yref_x, yref_u):
        """Exact merit of L dynamics-feasible candidates (``ocp/solver.py:
        182-214``): the LS objective, the soft input-bound penalty and an L1
        penalty on hard-bound violation. xs_c (L,N+1,nx), us_c (L,N,nu) ->
        (L,)."""
        dxr = xs_c[:, :-1] - yref_x[:-1]
        dur = us_c - yref_u
        obj = 0.5 * torch.einsum("lki,ij,lkj->l", dxr, self.Q, dxr)
        obj = obj + 0.5 * torch.einsum("lki,ij,lkj->l", dur, self.R, dur)
        dterm = xs_c[:, -1] - yref_x[-1]
        obj = obj + 0.5 * torch.einsum("li,ij,lj->l", dterm, self.QN, dterm)

        def violation(v, lb, ub):
            lo = torch.where(torch.isfinite(lb), lb - v, torch.zeros_like(v))
            hi = torch.where(torch.isfinite(ub), v - ub, torch.zeros_like(v))
            return lo.clamp(min=0.0), hi.clamp(min=0.0)

        vlo, vhi = violation(us_c, self.u_lb, self.u_ub)
        softf = self.u_soft
        hardf = 1.0 - softf
        pen = self.spec.ls_penalty
        obj = obj + (softf * (self.u_zl * vlo + self.u_zu * vhi)).sum((1, 2))
        obj = obj + 0.5 * (softf * (self.u_Zl * vlo**2
                                    + self.u_Zu * vhi**2)).sum((1, 2))
        obj = obj + pen * (hardf * (vlo + vhi)).sum((1, 2))
        xlo, xhi = violation(xs_c[:, 1:], self.x_lb, self.x_ub)
        return obj + pen * (xlo + xhi).sum((1, 2))

    @torch.no_grad()
    def solve(self, x0, yref_x, yref_u, params, state: SolverState) -> SolveResult:
        """One MPC solve. x0 (nx,), yref_x (N+1,nx), yref_u (N,nu), params
        (p_dim,) or (N,p_dim), state (xs (N+1,nx), us (N,nu))."""
        spec, dt = self.spec, self.dtype
        N = spec.n_nodes
        self._check_tf32(x0)
        x0, yref_x, yref_u = x0.to(dt), yref_x.to(dt), yref_u.to(dt)
        params = params.to(dt)
        ps = params if params.ndim == 2 else params.expand(N, -1)
        xs, us = state.xs.to(dt), state.us.to(dt)
        if spec.yaw_wrap_idx is not None:
            i = spec.yaw_wrap_idx
            yref_x = yref_x.clone()
            yref_x[:, i] = yaw_wrap_reference(yref_x[:, i], x0[i])

        alpha = None
        for _ in range(spec.sqp_iters):
            xs = xs.clone()
            xs[0] = x0
            us = us.contiguous()
            A, Bm, c = self._linearize(xs, us, params)
            dx, du, alpha = self._qp_step(xs[None], us[None], A[None], Bm[None],
                                          c[None], yref_x[None], yref_u[None])
            if spec.ls_steps > 1:
                us_c = us + self.ls_alphas[:, None, None] * du
                xs_c = self._rollout(x0, us_c, ps)
                best = torch.argmin(self._merit(xs_c, us_c, yref_x, yref_u))[None]
                xs = xs_c.index_select(0, best)[0]
                us = us_c.index_select(0, best)[0]
            else:
                xs, us = xs + dx[0], us + du[0]

        defect = self._defect(*self._as_batch(xs, us, params))
        kkt = torch.sqrt(torch.mean(defect**2))
        return SolveResult(us=us, xs=xs, state=SolverState(xs, us),
                           kkt_residual=kkt, alpha=alpha[0])

    @staticmethod
    def shift(state: SolverState) -> SolverState:
        """RTI shift: advance the warm start one stage (the reference's
        implicit RTI warm start)."""
        xs = torch.cat([state.xs[1:], state.xs[-1:]], dim=0)
        us = torch.cat([state.us[1:], state.us[-1:]], dim=0)
        return SolverState(xs=xs, us=us)

    @torch.no_grad()
    def init_state(self, x0, u0=None) -> SolverState:
        """Cold start: the rollout from x0 under the constant control u0
        (zero by default) with p = 0 (``ocp/solver.py:282-294``)."""
        spec, dev = self.spec, self.Q.device
        x0 = torch.as_tensor(x0, dtype=self.dtype, device=dev)
        u0 = (torch.zeros(spec.nu, dtype=self.dtype, device=dev) if u0 is None
              else torch.as_tensor(u0, dtype=self.dtype, device=dev))
        us = u0.expand(spec.n_nodes, -1).contiguous()
        ps = x0.new_zeros((spec.n_nodes, self.p_dim))
        xs = self._rollout(x0, us[None], ps)[0]
        return SolverState(xs=xs, us=us)
