"""MPC problem specs and the AD controller facade (port of
``ad_mpc_tpu/control/mpc.py:26-192, 194-218``).

:func:`bicycle_spec`, :func:`quad_spec` and :class:`BicycleMPC` are
ported; ``QuadMPC`` (the dual-state GP with per-stage parameters and
per-solve cluster selection) is not yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ad_mpc_tpu_torch.control import safety
from ad_mpc_tpu_torch.models.bicycle import (
    BicycleDynamics,
    BicycleParams,
    blend_switch,
)
from ad_mpc_tpu_torch.ocp.solver import SolverState, SQPSolver
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
