"""MPC problem specs (port of ``ad_mpc_tpu/control/mpc.py:26-58,
194-218``).

:func:`bicycle_spec` and :func:`quad_spec` are ported; the controller
facades (``BicycleMPC``, ``QuadMPC``) come with the single-vehicle path.
"""

from __future__ import annotations

import numpy as np

from ad_mpc_tpu_torch.models.bicycle import BicycleParams
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
