"""The quadrotor fleet on the parameter-routed GP: one launch for a fleet
whose scenarios use different clusters.

The capability ``ad_mpc_tpu/learned/lane.py:204-211`` names for
``param_residual_dynamics``: each scenario carries its own cluster's GP
in its parameter row, gathered outside the kernels by nearest centroid
at the scenario's body-frame velocity, once per tick
(``learned.lane.ClusterPacker``), so that a mixed-cluster fleet runs in
one launch of each kernel. The fleet is c6's (``quad_fleet``: circle
references, the scenario draws, N=10, ``qp_iters=18``, two Gauss-Newton
iterations) on :class:`GPQuadRoutedDynamics` (the ``GPQuadRoutedDyn``
functor of ``csrc/vde_gp_quad_routed.cu``). On a CUDA device a tick is two
launches each of the sweep and the QP kernel and two of the RK4 map (the
KKT defect and the plant step, both with the scenarios' p rows), as c6's.
"""

from __future__ import annotations

from ad_mpc_tpu_torch.control.mpc import quad_spec
from ad_mpc_tpu_torch.experiments.quad_fleet import QUAD_SQP_ITERS, fleet_loop
from ad_mpc_tpu_torch.learned.ensemble import GPEnsemble
from ad_mpc_tpu_torch.learned.lane import param_residual_dynamics
from ad_mpc_tpu_torch.models.quadrotor import QuadDynamics, QuadrotorParams
from ad_mpc_tpu_torch.ocp.solver import BatchedSQPSolver
from ad_mpc_tpu_torch.utils.math import quaternion_inverse, v_dot_q

LAUNCHES_PER_TICK = {"vde": 2, "lq_ipm": 2, "rk4": 2}


def body_velocities(x):
    """(B, 3) body-frame velocities ``R(q)^T v`` of quad states x (B, 13)."""
    return v_dot_q(x[:, 7:10], quaternion_inverse(x[:, 3:7]))


def build_routed_quad_fleet(ensemble: GPEnsemble, n_nodes=10, qp_iters=18,
                            sqp_iters=QUAD_SQP_ITERS,
                            params: QuadrotorParams = QuadrotorParams(),
                            device="cuda", backend="auto"):
    """The c6 fleet with ``ensemble``'s body-frame GP routed through p.

    Returns (tick, init, solver, spec, pack); tick(carry) -> (carry, (kkt,
    lat, p)), carry = (x0, theta, radius, speed, alt, states), p the tick's
    (B, p_dim) rows."""
    spec = quad_spec(n_nodes=n_nodes, qp_iters=qp_iters, sqp_iters=sqp_iters)
    dyn, p_dim, pack = param_residual_dynamics(ensemble, QuadDynamics(params), 0,
                                               quad_frame=True)
    solver = BatchedSQPSolver(spec, dyn, p_dim=p_dim, device=device, backend=backend)
    tick, init = fleet_loop(solver, spec, params, lambda x0: pack(body_velocities(x0)))
    return tick, init, solver, spec, pack
