"""MPC problem specs and the controller facades (port of
``ad_mpc_tpu/control/mpc.py``): :func:`bicycle_spec` and
:class:`BicycleMPC` for the AD vehicle, :func:`quad_spec` and
:class:`QuadMPC` for the quadrotor (nominal, RDRv drag, a GP residual, and
the dual-state GP with per-stage parameters and per-solve cluster
selection).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from torch import nn
from torch.func import vmap

from ad_mpc_tpu_torch.control import safety
from ad_mpc_tpu_torch.learned.ensemble import (
    GPEnsemble, QuadResidual, body_frame_features, on_device, predict,
    select_cluster)
from ad_mpc_tpu_torch.learned.lane import add_rows
from ad_mpc_tpu_torch.models.bicycle import (
    BicycleDynamics,
    BicycleParams,
    blend_switch,
)
from ad_mpc_tpu_torch.models.gp_quad import (
    GP_QUAD_POINTS, GPQuadDualDynamics, GPQuadDynamics, GPQuadSelectDynamics,
    dual_gp_rows)
from ad_mpc_tpu_torch.models.quadrotor import (
    QuadDragDynamics, QuadDynamics, QuadrotorParams, drag_matrix,
    quad_drag_rows, quad_dynamics_lane)
from ad_mpc_tpu_torch.ocp.solver import SolverState, SQPSolver, resolve_backend
from ad_mpc_tpu_torch.ocp.spec import OCPSpec


def bicycle_spec(
    t_horizon: float = 2.0,
    n_nodes: int = 40,
    q_cost=(10.0, 10.0, 100.0, 0.0, 0.0, 0.0, 0.0),
    r_cost=(1.0, 100.0),
    params: BicycleParams = BicycleParams(),
    sqp_iters: int = 1,
    qp_iters: int = 18,
) -> OCPSpec:
    """AD OCP spec with the reference's dims/weights/bounds: N=40, tf=2 s,
    W_e = Q*1e-6, soft input box + hard steering box."""
    p = params
    return OCPSpec(
        n_nodes=n_nodes,
        t_horizon=t_horizon,
        nx=7,
        nu=2,
        q_cost=tuple(q_cost),
        r_cost=tuple(r_cost),
        w_e_cost=tuple(1e-6 * np.asarray(q_cost)),
        lbu=(p.acc_min, p.steering_rate_min),
        ubu=(p.acc_max, p.steering_rate_max),
        lbx=(-np.inf,) * 6 + (p.steering_min,),
        ubx=(np.inf,) * 6 + (p.steering_max,),
        soft_u=(True, True),
        zl_u=10.0,
        zu_u=10.0,
        sqp_iters=sqp_iters,
        qp_iters=qp_iters,
        yaw_wrap_idx=2,
    )


class BicycleMPC:
    """AD vehicle MPC: the L3 facade and its safety shell over one
    :class:`SQPSolver`.

    ``optimize(x)`` solves, gates the solution through
    ``is_valid_command`` and falls back to the shifted previous plan when
    it is implausible. ``point_reference=True`` selects the full-SQP mode
    the reference uses for single-point targets: 10 globalized
    Gauss-Newton iterations (6 line-search candidates) per solve instead of
    one RTI step. ``device``/``backend``/``dtype`` are the solver's.
    """

    def __init__(self, params: BicycleParams = BicycleParams(),
                 spec: Optional[OCPSpec] = None, point_reference: bool = False,
                 dtype=torch.float32, device="cuda", backend: str = "auto"):
        self.params = params
        self.spec = spec if spec is not None else bicycle_spec(params=params)
        if point_reference and self.spec.sqp_iters == 1:
            self.spec = dataclasses.replace(self.spec, sqp_iters=10, ls_steps=6)
        self.solver = SQPSolver(self.spec, BicycleDynamics(params), p_dim=1,
                                dtype=dtype, device=device, backend=backend)
        self.device, self.dtype = torch.device(device), dtype
        self.state: Optional[SolverState] = None
        self._prev_us = None
        self._yref_x = None
        self._yref_u = None

    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device).to(self.dtype)

    def set_reference(self, x_ref, u_ref=None):
        """x_ref: (M, 7) state reference, padded or truncated to N+1 rows by
        repeating the last row."""
        N = self.spec.n_nodes
        x_ref = np.atleast_2d(np.asarray(x_ref, dtype=float))
        if u_ref is None:
            u_ref = np.zeros((x_ref.shape[0], 2))
        u_ref = np.atleast_2d(np.asarray(u_ref, dtype=float))
        while x_ref.shape[0] < N + 1:
            x_ref = np.vstack([x_ref, x_ref[-1:]])
            u_ref = np.vstack([u_ref, u_ref[-1:]])
        self._yref_x = self._tensor(x_ref[: N + 1])
        self._yref_u = self._tensor(u_ref[:N])

    def optimize(self, x0, use_backup_gate: bool = True):
        """Returns (us (N,2), xs (N+1,7), ok flag). The flag is read on the
        host: one round trip per call."""
        x0 = self._tensor(x0)
        if self.state is None:
            self.state = self.solver.init_state(x0)
        sw = blend_switch(x0[3], self.params)
        res = self.solver.solve(x0, self._yref_x, self._yref_u, sw.reshape(1),
                                self.state)
        self.state = self.solver.shift(res.state)

        us, xs = res.us, res.xs
        ok = bool(safety.is_valid_command(xs, self._yref_x))
        if use_backup_gate:
            if ok:
                self._prev_us = us
            elif self._prev_us is not None:
                us = safety.backup_control(self._prev_us)
                self._prev_us = us
        return us, xs, ok

    def fused_init(self, x0):
        """The fused step's first carry (state, prev_us, have_prev) for the
        state x0: the cold-start warm start, no previous plan."""
        x0 = self._tensor(x0)
        return (self.solver.init_state(x0),
                x0.new_zeros((self.spec.n_nodes, 2)),
                torch.zeros((), dtype=torch.bool, device=self.device))

    def make_fused_step(self):
        """The deployment node's controller step: solve, RTI shift,
        plausibility gate (``is_valid_command``), predicted-trajectory
        health, backup-control selection and the steering command, with
        every tensor on the solver's device and nothing that waits for it.

        ``step(packed, state, prev_us, have_prev)``: packed (N+2, 7), row 0
        the state x0 and rows 1: the state reference (one host-to-device
        copy per tick). Returns ``(out, state, prev_us, have_prev)``; out
        (4,) = [accel, steer_rate, steer_cmd, healthy] is the only tensor
        the caller fetches.
        """
        solver, params, dev, dt = self.solver, self.params, self.device, self.dtype
        yref_u = torch.zeros((self.spec.n_nodes, 2), dtype=dt, device=dev)

        def step(packed, state, prev_us, have_prev):
            packed = packed.to(device=dev, dtype=dt, non_blocking=True)
            x0, yref_x = packed[0], packed[1:]
            sw = blend_switch(x0[3], params)
            res = solver.solve(x0, yref_x, yref_u, sw.reshape(1), state)
            new_state = solver.shift(res.state)
            ok = safety.is_valid_command(res.xs, yref_x)
            pred_ok = safety.check_pred_traj(res.xs, x0)
            use_backup = ~ok & have_prev
            us_out = torch.where(use_backup, safety.backup_control(prev_us),
                                 res.us)
            # Node-level steering integration.
            steer_cmd = torch.clamp(x0[6] + us_out[0, 1] * 0.1,
                                    params.steering_min, params.steering_max)
            out = torch.stack([us_out[0, 0], us_out[0, 1], steer_cmd,
                               (ok & pred_ok).to(dt)])
            return out, new_state, us_out, have_prev | ok

        return step

    def reset(self):
        self.state = None
        self._prev_us = None


def quad_spec(
    t_horizon: float = 1.0,
    n_nodes: int = 10,
    q_cost=(10, 10, 10, 0.1, 0.1, 0.1, 0.1, 0.05, 0.05, 0.05, 0.05, 0.05, 0.05),
    r_cost=(0.1, 0.1, 0.1, 0.1),
    sqp_iters: int = 1,
    qp_iters: int = 18,
) -> OCPSpec:
    """Quadrotor OCP spec with the reference's dims and weights: N=10,
    tf=1 s, nx=13, nu=4, a hard input box [0, 1], the 13 diagonal state
    weights also as the terminal weight."""
    return OCPSpec(
        n_nodes=n_nodes,
        t_horizon=t_horizon,
        nx=13,
        nu=4,
        q_cost=tuple(q_cost),
        r_cost=tuple(r_cost),
        w_e_cost=tuple(q_cost),
        lbu=(0.0,) * 4,
        ubu=(1.0,) * 4,
        sqp_iters=sqp_iters,
        qp_iters=qp_iters,
    )


def _per_vector(fn, x, u):
    """``fn(x, u)`` of one state (13,) and input (4,), on entries-leading
    tensors of any trailing shape: vmapped over the broadcast trailing
    axes."""
    if x.dim() == 1 and u.dim() == 1:
        return fn(x, u)
    shape = torch.broadcast_shapes(x.shape[1:], u.shape[1:])
    xs = x.expand(x.shape[0], *shape).reshape(x.shape[0], -1).T
    us = u.expand(u.shape[0], *shape).reshape(u.shape[0], -1).T
    return vmap(fn)(xs, us).T.reshape(x.shape[0], *shape)


class QuadModel(nn.Module):
    """QuadMPC's dynamics for any combination of its options, on the plain
    backend only (no functor): the quad, plus the RDRv drag
    (``rdrv_d``), plus ``residual_fn(x, u)`` of one state (vmapped over the
    trailing axes), plus the dual-state GP of ``ensemble`` (``p_dim = 1 +
    2D``; else 0)."""

    nx, nu = 13, 4

    def __init__(self, params: QuadrotorParams = QuadrotorParams(),
                 rdrv_d=None, residual_fn=None,
                 ensemble: Optional[GPEnsemble] = None):
        super().__init__()
        self.params, self.residual_fn, self.ensemble = params, residual_fn, ensemble
        self.D = None if rdrv_d is None else drag_matrix(rdrv_d)
        self.p_dim = 0 if ensemble is None else 1 + 2 * len(ensemble.out_idx)

    def forward(self, x, u, p):
        xd = quad_dynamics_lane(x, u, None, self.params)
        if self.D is not None:
            xd = add_rows(xd, quad_drag_rows(x, self.D))
        if self.residual_fn is not None:
            xd = xd + _per_vector(self.residual_fn, x, u)
        if self.ensemble is not None:
            xd = add_rows(xd, dual_gp_rows(self.ensemble, x, p))
        return xd


def quad_dynamics_for(params: QuadrotorParams = QuadrotorParams(), rdrv_d=None,
                      residual_fn=None, ensemble=None):
    """The dynamics of a QuadMPC mode: the one with a CUDA functor where the
    mode has one, else :class:`QuadModel` (plain backend only).

    ==============================================  ========================
    mode                                            dynamics (functor)
    ==============================================  ========================
    nominal                                         QuadDynamics (QuadDyn)
    ``rdrv_d=D``                                    QuadDragDynamics
    ``residual_fn=quad_residual_fn(ens)``, one      GPQuadDynamics
    cluster on the velocity layout (7, 8, 9)        (GPQuadDyn)
    ``residual_fn=quad_residual_fn(ens, c)``, any   GPQuadSelectDynamics
    other (the nearest centroid at every            (GPQuadSelectDyn)
    evaluation, or the clusters c pinned), and any
    of these with ``rdrv_d=D``
    ``ensemble=ens``, with or without ``rdrv_d=D``  GPQuadDualDynamics
    any other ``residual_fn``, or ``residual_fn``   QuadModel (plain only)
    with ``ensemble``
    ==============================================  ========================
    """
    if residual_fn is None and ensemble is None:
        return (QuadDynamics(params) if rdrv_d is None
                else QuadDragDynamics(rdrv_d, params))
    if residual_fn is None:
        return GPQuadDualDynamics(ensemble, params, rdrv_d)
    if ensemble is None and isinstance(residual_fn, QuadResidual):
        ens = residual_fn.ensemble
        if (rdrv_d is None and ens.n_clusters == 1
                and tuple(ens.out_idx) == tuple(ens.feat_idx) == (7, 8, 9)
                and ens.x_train.shape[2] <= GP_QUAD_POINTS):
            return GPQuadDynamics(ens, params)
        return GPQuadSelectDynamics(ens, params, residual_fn.fixed_cluster, rdrv_d)
    return QuadModel(params, rdrv_d, residual_fn, ensemble)


class QuadMPC:
    """Quadrotor MPC facade (port of ``ad_mpc_tpu/control/mpc.py:221-400``):
    one :class:`SQPSolver` over the dynamics of the mode
    (:func:`quad_dynamics_for`), a quaternion retraction of the warm start,
    and a solver-health watchdog.

    GP mode (``ensemble`` given) is the reference's dual-state mechanism:
    ``optimize(x0, gp_x0=...)`` evaluates the GP at node 0 on a second
    (EKF) state estimate through a per-stage parameter row ``[trigger, mu0
    (D), cluster (D)]`` with the trigger 1 at node 0 only; the cluster is
    picked per solve by nearest centroid at the warm start's horizon
    midpoint and pinned for the solve. Both run on the solver's device,
    with the ensemble copied there once; ``last_cluster`` is kept as a
    tensor and fetched when it is read.

    ``device``/``backend``/``dtype`` are the solver's. On ``backend="cuda"``
    a mode without a functor (a ``residual_fn`` other than
    ``quad_residual_fn``, or ``residual_fn`` with ``ensemble``) raises
    ``NotImplementedError``; the plain backend takes them all.
    """

    HEALTH_LIMIT = 100.0  # m/s: a larger |v| in the iterate is a divergence

    def __init__(self, params: QuadrotorParams = QuadrotorParams(),
                 spec: Optional[OCPSpec] = None, rdrv_d=None, residual_fn=None,
                 ensemble: Optional[GPEnsemble] = None, dtype=torch.float32,
                 device="cuda", backend: str = "auto"):
        self.params = params
        self.spec = spec if spec is not None else quad_spec()
        self.ensemble = ensemble
        self.n_resets = 0  # solver-health resets (observability)
        self._last_cluster = None
        self.device, self.dtype = torch.device(device), dtype
        dyn = quad_dynamics_for(params, rdrv_d, residual_fn, ensemble)
        if (resolve_backend(backend, device) == "cuda"
                and getattr(dyn, "cuda_entry", None) is None):
            raise NotImplementedError(
                "QuadMPC on backend='cuda' has a functor for every mode but a "
                "residual_fn other than quad_residual_fn (the JAX package "
                "traces any callable) and residual_fn together with ensemble "
                "(ROADMAP Queue A 8); use backend='plain' for these")
        self.solver = SQPSolver(self.spec, dyn, p_dim=dyn.p_dim, dtype=dtype,
                                device=device, backend=backend)
        N = self.spec.n_nodes
        if ensemble is not None:
            self._ens = on_device(ensemble, dtype, self.device)
            self._trigger = torch.zeros((N, 1), dtype=dtype, device=self.device)
            self._trigger[0, 0] = 1.0
        self._no_params = torch.zeros((0,), dtype=dtype, device=self.device)
        self.state: Optional[SolverState] = None
        self._yref_x = None
        self._yref_u = None

    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device).to(self.dtype)

    @property
    def last_cluster(self):
        """The cluster per output dim of the last GP-mode solve (numpy), or
        None."""
        c = self._last_cluster
        return None if c is None else c.cpu().numpy()

    def set_reference(self, x_ref, u_ref=None):
        """x_ref: (M, 13) state reference, one row tiled over the horizon,
        else padded or truncated to N+1 rows by repeating the last row."""
        N = self.spec.n_nodes
        x_ref = np.atleast_2d(np.asarray(x_ref, dtype=float))
        if x_ref.shape[0] == 1:
            x_ref = np.tile(x_ref, (N + 1, 1))
        if u_ref is None:
            u_ref = np.zeros((x_ref.shape[0], 4))
        u_ref = np.atleast_2d(np.asarray(u_ref, dtype=float))
        while x_ref.shape[0] < N + 1:
            x_ref = np.vstack([x_ref, x_ref[-1:]])
            u_ref = np.vstack([u_ref, u_ref[-1:]])
        self._yref_x = self._tensor(x_ref[: N + 1])
        self._yref_u = self._tensor(u_ref[:N])

    def _stage_params(self, x0, gp_x0):
        """(N, 1+2D) per-stage rows of the GP mode, or the empty p."""
        if self.ensemble is None:
            return self._no_params
        ens, N = self._ens, self.spec.n_nodes
        z_mid = body_frame_features(self.state.xs[N // 2], ens.feat_idx)
        cl = select_cluster(ens, z_mid)
        self._last_cluster = cl
        x_gp = x0 if gp_x0 is None else self._tensor(gp_x0)
        mu0 = predict(ens, body_frame_features(x_gp, ens.feat_idx), cluster_idx=cl)
        row = torch.cat([mu0, cl.to(mu0.dtype)])
        return torch.cat([self._trigger, row.expand(N, -1)], dim=1)

    def _warm_start(self, x0):
        """The solve's warm start: the cold start from x0, or the RTI
        retraction of the stored iterate's quaternions back to unit norm
        before linearizing (the OCP treats q as 4 free states; at one
        Gauss-Newton iteration the norm can drift far off). The
        max(norm, 1e-8) guard keeps a zero quaternion finite, which the
        JAX package divides by unguarded."""
        if self.state is None:
            self.state = self.solver.init_state(x0)
            return
        xs = self.state.xs.clone()
        qs = xs[:, 3:7]
        xs[:, 3:7] = qs / torch.linalg.norm(qs, dim=1, keepdim=True).clamp(min=1e-8)
        self.state = self.state._replace(xs=xs)

    @staticmethod
    def _health(res):
        """inf when an entry of us or xs is not finite, else max |v|."""
        ok = torch.isfinite(res.us).all() & torch.isfinite(res.xs).all()
        return torch.where(ok, res.xs[:, 7:10].abs().max(),
                           torch.full_like(res.xs[0, 0], float("inf")))

    def optimize(self, x0, gp_x0=None):
        """One solve; returns (us (N,4), xs (N+1,13)) on the solver's device.
        ``gp_x0``: a second (EKF) state estimate used only for the node-0 GP
        evaluation; the dynamics and the x0 bound use ``x0``. The watchdog's
        one scalar fetch is the solve's only host synchronization."""
        x0 = self._tensor(x0)
        self._warm_start(x0)
        params = self._stage_params(x0, gp_x0)
        res = self.solver.solve(x0, self._yref_x, self._yref_u, params, self.state)
        if not float(self._health(res)) < self.HEALTH_LIMIT:
            # A non-finite or implausible iterate would poison every later
            # warm start: reset to the current state and re-solve once.
            self.n_resets += 1
            self.state = self.solver.init_state(x0)
            res = self.solver.solve(x0, self._yref_x, self._yref_u, params,
                                    self.state)
            if not float(self._health(res)) < self.HEALTH_LIMIT:
                # Still pathological from a cold start: keep no iterate (the
                # next solve starts fresh); the caller gets this output.
                self.state = None
                return res.us, res.xs
        self.state = self.solver.shift(res.state)
        return res.us, res.xs

    def reset(self):
        self.state = None
