"""Typed OCP specification (copy of ``ad_mpc_tpu/ocp/spec.py``; numpy only).

The port keeps its own copy because importing the JAX package's module
pulls in jax through ``ad_mpc_tpu/ocp/__init__.py``. ``matmul_precision``
is kept so that specs convert field by field; in the port it is a check in
the solver that TF32 matmuls are off.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class OCPSpec:
    """Linear-LS optimal control problem over horizon N.

    Cost (ACADOS LINEAR_LS parity):
        sum_k dt * 0.5*(||x_k - xref_k||^2_Q + ||u_k - uref_k||^2_R)
        + 0.5*||x_N - xref_N||^2_{W_e}
    with ``cost_scaling='acados'`` scaling stage costs by dt = tf/N and the
    terminal cost by 1.
    """

    n_nodes: int  # N: shooting intervals
    t_horizon: float  # tf [s]
    nx: int
    nu: int
    q_cost: tuple  # diag of Q, length nx
    r_cost: tuple  # diag of R, length nu
    w_e_cost: tuple  # diag of terminal W_e, length nx

    # Box bounds (None entries -> +-inf). Soft entries carry L1 penalty z*.
    lbu: tuple = ()
    ubu: tuple = ()
    lbx: tuple = ()  # length nx, +-inf for unbounded
    ubx: tuple = ()
    soft_u: tuple = ()  # bool per input (ACADOS idxsbu)
    soft_x: tuple = ()  # bool per state
    zl_u: float = 10.0  # L1 slack penalty
    zu_u: float = 10.0
    Zl_u: float = 0.0
    Zu_u: float = 0.0

    # Integrator / solver options.
    rk4_steps: int = 1  # ERK sub-steps per shooting interval
    sqp_iters: int = 1  # 1 = RTI, >1 = full SQP
    qp_iters: int = 18  # fixed IPM iteration count
    levenberg: float = 1e-8  # Riccati regularization
    ls_steps: int = 1  # line-search candidates (single-vehicle solver only)
    ls_penalty: float = 1e3
    assoc_riccati: bool = False  # associative-scan Riccati (plain backend)
    cost_scaling: str = "acados"  # 'acados' (dt-scaled stages) or 'unit'
    # 'highest' = true f32 matmuls; the port's solver checks that
    # torch.backends.cuda.matmul.allow_tf32 is False.
    matmul_precision: str = "highest"
    # Yaw-wrap correction applied to this state index of yref (None = off).
    yaw_wrap_idx: Optional[int] = None

    @property
    def dt(self) -> float:
        return self.t_horizon / self.n_nodes

    @property
    def stage_scale(self) -> float:
        return self.dt if self.cost_scaling == "acados" else 1.0

    def weight_arrays(self, dtype=np.float64):
        s = self.stage_scale
        Q = np.diag(np.asarray(self.q_cost, dtype=dtype)) * s
        R = np.diag(np.asarray(self.r_cost, dtype=dtype)) * s
        QN = np.diag(np.asarray(self.w_e_cost, dtype=dtype))
        return Q, R, QN

    def bound_arrays(self, dtype=np.float64):
        def arr(t, n, fill):
            if not t:
                return np.full(n, fill, dtype=dtype)
            return np.asarray(t, dtype=dtype)

        lbu = arr(self.lbu, self.nu, -np.inf)
        ubu = arr(self.ubu, self.nu, np.inf)
        lbx = arr(self.lbx, self.nx, -np.inf)
        ubx = arr(self.ubx, self.nx, np.inf)
        soft_u = (
            np.asarray(self.soft_u, dtype=bool)
            if self.soft_u
            else np.zeros(self.nu, dtype=bool)
        )
        soft_x = (
            np.asarray(self.soft_x, dtype=bool)
            if self.soft_x
            else np.zeros(self.nx, dtype=bool)
        )
        return lbu, ubu, lbx, ubx, soft_u, soft_x

    def bound_dicts(self):
        """(u_bounds, x_bounds): numpy dicts with lb/ub/soft/zl/zu/Zl/Zu per
        variable group, penalties zeroed on hard entries (the JAX solver's
        ``_u_bounds_np``/``_x_bounds_np``, ``ocp/solver.py:109-136``)."""
        lbu, ubu, lbx, ubx, soft_u, soft_x = self.bound_arrays()
        zeros_x = np.zeros(self.nx)
        u = dict(
            lb=lbu, ub=ubu, soft=soft_u,
            zl=np.where(soft_u, self.zl_u, 0.0),
            zu=np.where(soft_u, self.zu_u, 0.0),
            Zl=np.where(soft_u, self.Zl_u, 0.0),
            Zu=np.where(soft_u, self.Zu_u, 0.0),
        )
        x = dict(lb=lbx, ub=ubx, soft=soft_x,
                 zl=zeros_x, zu=zeros_x, Zl=zeros_x, Zu=zeros_x)
        return u, x
