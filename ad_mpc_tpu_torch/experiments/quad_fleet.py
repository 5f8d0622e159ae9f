"""The closed-loop quadrotor fleets of bench configs c5 and c6, on the port.

Port of ``ad_mpc_tpu/experiments/quad_fleet.py``. Each vehicle tracks a
horizontal circle of its own radius, speed and altitude with a hover
attitude reference, at the reference's quad OCP dims (nx=13, nu=4, N=10,
tf=1 s, ``qp_iters=18``) and two Gauss-Newton iterations per tick
(``bench.py:471``). With an ``ensemble`` (c6) the dynamics carry the
body-frame GP residual ``R(q) GP(R(q)^T v)`` of its cluster 0
(:class:`GPQuadDynamics`): the bench's synthetic ensemble
(:func:`make_quad_gp_ensemble`) or the fitted ``gp_flagship_c1`` model
carried across from the JAX package (:func:`fitted_ensemble`). On a CUDA
device a tick is two launches each of the VDE sweep (``vde_quad`` or
``vde_gp_quad``) and the QP kernel (``lq_ipm`` at 13x4), one of the RK4 map
for the KKT defect and one for the plant step, which the quaternion
renormalization follows.

Scenario and ensemble draws use ``numpy.random.default_rng(seed)`` exactly
as the JAX package does, so both packages drive the same fleet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ad_mpc_tpu_torch.control.mpc import quad_spec
from ad_mpc_tpu_torch.learned.ensemble import GPEnsemble, load_npz
from ad_mpc_tpu_torch.learned.gp import GPParams
from ad_mpc_tpu_torch.models.gp_quad import GPQuadDynamics
from ad_mpc_tpu_torch.models.quadrotor import (
    QuadDynamics,
    QuadrotorParams,
    hover_input,
    normalize_quat_state,
)
from ad_mpc_tpu_torch.ocp.solver import BatchedSQPSolver, SolverState
from ad_mpc_tpu_torch.utils.metrics import span

# Gauss-Newton iterations per deployed tick (``bench.py:471``): one RTI
# iteration leaves the attitude linearization residue at dt=0.1 near the
# 1e-3 parity bar, the second collapses it.
QUAD_SQP_ITERS = 2
# Quality gates of configs c5 and c6 (``bench.py:483-491, 497-498``). The
# fitted model's drag residual is about 100x the synthetic ensemble's, and
# so is its linearization residue: looser KKT gates.
GATES = {"kkt_mean": 2e-6, "kkt_max": 1e-4, "lat_err_mean_m": 0.02}
FITTED_GATES = {"kkt_mean": 1e-4, "kkt_max": 5e-4, "lat_err_mean_m": 0.02}
RTI_GATE = 1e-3  # max |u0_deployed - u0_converged|, c5 and c6
# The fitted GP of the JAX package's record->fit pipeline
# (results/model_fitting/256298c/gp_flagship_c1), carried across by
# ``convert.save_gp_ensemble``.
FITTED_NPZ = Path(__file__).resolve().parents[1] / "data" / "gp_flagship_c1.npz"
# The JAX package's two-cluster candidate of the same fit (its
# gp_flagship.stage_fit fits one every time), carried across likewise.
FITTED_C2_NPZ = FITTED_NPZ.with_name("gp_flagship_c2.npz")
# The flagship's fitted RDRv drag matrix (a copy of the JAX package's
# results/experiments/gp_flagship/rdrv_d.npy).
FITTED_RDRV = FITTED_NPZ.with_name("rdrv_d.npy")
# Launches of each kernel per tick on the cuda backend, at QUAD_SQP_ITERS:
# the sweep and the QP per iteration, the RK4 map for the KKT defect and
# the plant step.
LAUNCHES_PER_TICK = {"vde": 2, "lq_ipm": 2, "rk4": 2}


def circle_reference(theta0, radius, omega, alt, N, dt):
    """(B, N+1, 13) state references along horizontal circles: position
    and world velocity from the circle geometry, hover attitude, zero
    rates. theta0, radius, omega, alt are (B,)."""
    ar = torch.arange(N + 1, dtype=torch.float32, device=theta0.device)
    th = theta0[:, None] + omega[:, None] * ar * dt
    r, om = radius[:, None], omega[:, None]
    zeros, ones = torch.zeros_like(th), torch.ones_like(th)
    return torch.stack(
        [
            r * torch.cos(th),
            r * torch.sin(th),
            alt[:, None].expand_as(th),
            ones, zeros, zeros, zeros,  # q = identity (hover attitude)
            -r * om * torch.sin(th),
            r * om * torch.cos(th),
            zeros,
            zeros, zeros, zeros,
        ],
        dim=-1,
    )


def make_quad_scenarios(batch, seed=0):
    """Per-scenario circle radius, speed and altitude, float32 numpy."""
    rng = np.random.default_rng(seed)
    radius = rng.uniform(2.0, 6.0, batch).astype(np.float32)
    speed = rng.uniform(1.0, 4.0, batch).astype(np.float32)
    alt = rng.uniform(1.0, 3.0, batch).astype(np.float32)
    return radius, speed, alt


def make_quad_gp_ensemble(seed: int = 23, n: int = 32,
                          clusters: int = 1) -> GPEnsemble:
    """The bench's synthetic ensemble on the quad's velocity residual
    (``ad_mpc_tpu/experiments/quad_fleet.py:63-87``): per output dim 7, 8,
    9, one cluster of ``n`` body-frame velocities in [-5, 5]^3 with a
    drag-like target, the same draw and solve as the JAX package's.
    ``clusters`` > 1 draws more clusters per dim after each dim's first,
    cluster c's velocities shifted by 4 c m/s on every axis (a multi-cluster
    ensemble for the dual-state GP's kernels)."""
    rng = np.random.default_rng(seed)
    gps = [[], [], []]
    for dim in range(3):
        for c in range(clusters):
            X = rng.uniform(-5.0, 5.0, (n, 3)) + 4.0 * c
            # Drag-like residual: quadratic in the dim's own body velocity.
            y = -0.03 * X[:, dim] * np.abs(X[:, dim]) + 0.01 * X[:, (dim + 1) % 3]
            ls = np.full(3, 2.5)
            sf, sn = 0.05, 0.02
            diff = (X[:, None, :] - X[None, :, :]) / ls
            K = sf * np.exp(-0.5 * np.sum(diff * diff, axis=-1))
            K += (sn**2 + 1e-6) * np.eye(n)
            gps[dim].append(GPParams(
                x_train=X, k_inv_y=np.linalg.solve(K, y - y.mean()),
                len_scale=ls, sigma_f=sf, sigma_n=sn, y_mean=float(y.mean()),
                centroid=X.mean(axis=0)))
    return GPEnsemble.from_gps(gps, out_idx=(7, 8, 9), feat_idx=(7, 8, 9))


def fitted_ensemble() -> GPEnsemble:
    """The fitted ``gp_flagship_c1`` ensemble (1 cluster, 60 points) of the
    bench's c6-fitted rows (``bench.py:833-854``)."""
    return load_npz(FITTED_NPZ)


def fitted_ensemble_c2() -> GPEnsemble:
    """The JAX package's fitted two-cluster candidate ``gp_flagship_c2`` (2
    clusters of 60 points per output, on the committed recording): the
    clustered GP of QuadMPC's ``quad_residual_fn`` rows."""
    return load_npz(FITTED_C2_NPZ)


def fitted_rdrv_d() -> np.ndarray:
    """The flagship's fitted 3x3 RDRv drag matrix D (QuadMPC's ``rdrv_d``)."""
    return np.load(FITTED_RDRV)


def build_quad_fleet(n_nodes=10, qp_iters=18, sqp_iters=QUAD_SQP_ITERS,
                     params: QuadrotorParams = QuadrotorParams(),
                     device="cuda", backend="auto", ensemble=None):
    """Closed-loop quad fleet over :class:`BatchedSQPSolver` with
    ``p_dim=0``. ``backend`` is the solver's (``"cuda"``, ``"plain"`` or
    ``"auto"``). ``ensemble``: a :class:`GPEnsemble` whose cluster-0
    body-frame residual the dynamics add (config c6); None for the nominal
    quad of c5.

    Returns (tick, init, solver, spec); tick(carry) -> (carry, (kkt, lat)),
    carry = (x0, theta, radius, speed, alt, states).
    """
    spec = quad_spec(n_nodes=n_nodes, qp_iters=qp_iters, sqp_iters=sqp_iters)
    dyn = (QuadDynamics(params) if ensemble is None
           else GPQuadDynamics(ensemble, params))
    solver = BatchedSQPSolver(spec, dyn, p_dim=0, device=device,
                              backend=backend)
    tick_p, init = fleet_loop(solver, spec, params,
                              lambda x0: x0.new_zeros((x0.shape[0], 0)))

    def tick(carry):
        carry, (kkt, lat, _) = tick_p(carry)
        return carry, (kkt, lat)

    return tick, init, solver, spec


def fleet_loop(solver, spec, params, p_of):
    """The tick and init of the circle-tracking fleet over ``solver``.
    ``p_of(x0)`` gives a tick's (B, p_dim) parameter rows from the fleet's
    states.

    tick(carry) -> (carry, (kkt, lat, p)), carry = (x0, theta, radius,
    speed, alt, states); init(batch, seed) -> carry.
    """
    N, dt = spec.n_nodes, spec.dt
    dev = solver.Q.device
    u_hover = torch.as_tensor(hover_input(params), dtype=torch.float32,
                              device=dev)

    def tick(carry):
        with span("fleet.tick"):
            x0, theta, radius, speed, alt, states = carry
            B = x0.shape[0]
            with span("fleet.reference"):
                omega = speed / radius
                yref_x = circle_reference(theta, radius, omega, alt, N, dt)
                yref_u = u_hover.expand(B, N, -1)
                p = p_of(x0)
            res = solver.solve(x0, yref_x, yref_u, p, states)
            with span("fleet.plant"), torch.no_grad():
                x_next = normalize_quat_state(solver.F(x0, res.us[:, 0], p))
            states = solver.shift(res.state)
            lat = torch.linalg.norm(x_next[:, :3] - yref_x[:, 1, :3], dim=-1)
            return (x_next, theta + omega * dt, radius, speed, alt, states), (
                res.kkt_residual, lat.mean(), p)

    def init(batch, seed=0):
        radius, speed, alt = (torch.as_tensor(a, device=dev)
                              for a in make_quad_scenarios(batch, seed))
        theta = torch.zeros((batch,), dtype=torch.float32, device=dev)
        x0 = circle_reference(theta, radius, speed / radius, alt, 0, dt)[:, 0]
        states = SolverState(
            xs=x0[:, None].expand(-1, N + 1, -1).contiguous(),
            us=u_hover.expand(batch, N, -1).contiguous(),
        )
        return (x0, theta, radius, speed, alt, states)

    return tick, init


def rti_vs_converged_quad(carry, n_check=64, n_nodes=10,
                          deployed_sqp_iters=QUAD_SQP_ITERS, ensemble=None):
    """Quality gate: max |u0| difference, over the first ``n_check``
    vehicles, between the deployed tick (``deployed_sqp_iters``
    Gauss-Newton iterations, 18 IPM iterations) and a converged SQP solve
    (6 and 24) from the same state and warm start, both with the dynamics
    of ``ensemble`` (as :func:`build_quad_fleet`)."""
    x0, theta, radius, speed, alt, states = carry
    m = min(n_check, x0.shape[0])
    dev = x0.device
    _, _, sol1, spec = build_quad_fleet(n_nodes=n_nodes, qp_iters=18,
                                        sqp_iters=deployed_sqp_iters,
                                        device=dev, ensemble=ensemble)
    _, _, sol6, _ = build_quad_fleet(n_nodes=n_nodes, qp_iters=24,
                                     sqp_iters=6, device=dev, ensemble=ensemble)
    N, dt = spec.n_nodes, spec.dt
    yref_x = circle_reference(theta[:m], radius[:m], (speed / radius)[:m],
                              alt[:m], N, dt)
    u_h = torch.as_tensor(hover_input(), dtype=torch.float32, device=dev)
    yref_u = u_h.expand(m, N, -1)
    p = x0.new_zeros((m, 0))
    st = SolverState(states.xs[:m].contiguous(), states.us[:m].contiguous())
    u_rti = sol1.solve(x0[:m], yref_x, yref_u, p, st).us[:, 0]
    u_cvg = sol6.solve(x0[:m], yref_x, yref_u, p, st).us[:, 0]
    return float((u_rti - u_cvg).abs().max())
