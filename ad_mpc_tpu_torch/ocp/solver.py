"""Batched SQP-RTI nonlinear MPC solver (port of ``ad_mpc_tpu/ocp/solver.py``).

Each solve runs ``spec.sqp_iters`` Gauss-Newton iterations over the whole
fleet. With ``backend="cuda"`` one iteration is two kernel launches:

- the fused RK4 + forward-sensitivity sweep (``ops/cuda_vde.py:VDE``);
- the fused fixed-iteration interior-point QP (``ops/cuda_lq.py``);

and the KKT defect of the returned iterate and :meth:`BatchedSQPSolver.F`
(the fleet's plant step) are one launch each of the sweep's tangent-free
RK4 kernel (``ops/cuda_vde.py:RK4``).

``backend="plain"`` runs their plain PyTorch versions instead, on any
device; it is the counterpart of the JAX package's ``backend='xla'`` and
the only backend that takes ``spec.assoc_riccati`` (the LQ kernel runs the
sequential recursion). ``"auto"`` picks ``"cuda"`` on a CUDA device and
``"plain"`` on the CPU. The RTI warm start is an explicit
:class:`SolverState` threaded through solves and shifted.

Not in this slice: the single-vehicle ``SQPSolver`` (line search) and the
multi-device ``mesh``.
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
    """RTI warm-start iterate: xs (B, N+1, nx), us (B, N, nu)."""

    xs: torch.Tensor
    us: torch.Tensor


class SolveResult(NamedTuple):
    us: torch.Tensor  # (B, N, nu) optimized controls
    xs: torch.Tensor  # (B, N+1, nx) optimized states
    state: SolverState  # warm start for the next solve
    kkt_residual: torch.Tensor  # (B,) RMS dynamics defect of the iterate
    alpha: torch.Tensor  # (B,) last-QP step sizes (diagnostics)


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


class BatchedSQPSolver(nn.Module):
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
        super().__init__()
        backend = resolve_backend(backend, device)
        self.lqr_fn = _lqr_fn(spec, backend)
        if backend == "cuda" and torch.device(device).type != "cuda":
            raise ValueError("backend='cuda' launches the CUDA kernels; "
                             f"device={device!r} is not a CUDA device")
        _build.require_card(device)
        self.spec, self.p_dim, self.backend = spec, p_dim, backend
        self.f = dynamics
        N, nx, nu = spec.n_nodes, spec.nx, spec.nu
        Q, R, QN = spec.weight_arrays()
        u_bounds, x_bounds = spec.bound_dicts()
        self.register_buffer("Q", torch.as_tensor(Q, dtype=torch.float32))
        self.register_buffer("R", torch.as_tensor(R, dtype=torch.float32))
        self.register_buffer("QN", torch.as_tensor(QN, dtype=torch.float32))
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
        self.to(device)

    def F(self, x, u, p):
        """Discrete dynamics on batch-first tensors. The cuda backend takes
        x (M, nx), u (M, nu), p (M, p_dim) (``ops/cuda_vde.py:RK4``); the plain
        backend broadcasts leading axes (``integrators.discrete_step``)."""
        if self.backend == "cuda":
            return self.rk4(x, u, p)
        return self.rk4.plain(x, u, p)

    @torch.no_grad()
    def solve(self, x0, yref_x, yref_u, params, state: SolverState) -> SolveResult:
        """Batched solve. x0 (B,nx), yref_x (B,N+1,nx), yref_u (B,N,nu),
        params (B,p_dim), state batched likewise."""
        spec = self.spec
        if (x0.device.type == "cuda" and spec.matmul_precision == "highest"
                and torch.backends.cuda.matmul.allow_tf32):
            raise RuntimeError("matmul_precision='highest' needs "
                               "torch.backends.cuda.matmul.allow_tf32 = False")
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
            if self.backend == "cuda":
                A, Bm, c = self.vde(xs, us, params)
            else:
                A, Bm, c = self.vde.plain(xs, us, params)
            q_lin = torch.einsum("ij,bkj->bki", self.Q, xs[:, :-1] - yref_x[:, :-1])
            q_term = torch.einsum("ij,bj->bi", self.QN, xs[:, -1] - yref_x[:, -1])
            q = torch.cat([q_lin, q_term[:, None]], dim=1).contiguous()
            r = torch.einsum("ij,bkj->bki", self.R, us - yref_u).contiguous()
            if self.backend == "cuda":
                dx, du, alpha = self.qp(A, Bm, c, q, r, us, xs)
            else:
                dx, du, alpha = self.qp.plain(A, Bm, c, q, r, us, xs,
                                              lqr_fn=self.lqr_fn)
            xs, us = xs + dx, us + du

        if self.backend == "cuda":
            defect = self.rk4.defect(xs, us, params)
        else:
            defect = self.rk4.defect_plain(xs, us, params)
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
