"""The closed-loop bicycle fleets of bench configs c2, c3 and c4, on the port.

Port of ``bench.py:70-298, 303-455``: the c2 dynamic bicycle, the c3
GP-augmented bicycle (:func:`make_gp_bicycle`) and the c4 Pacejka
friction/topography sweep (:func:`make_pacejka`) share :func:`build_fleet`,
the tick and the gates machinery. Every tick is the full unit
of work: project each vehicle onto its arc and build its reference window,
run one batched SQP-RTI solve (two kernel launches per Gauss-Newton
iteration on a CUDA device, and one for the KKT defect), apply u0 to the
plant (one launch) and shift the warm start.

Scenario draws use ``numpy.random.default_rng(seed)`` exactly as the JAX
package's bench does, so both packages drive the same fleet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ad_mpc_tpu_torch.control.mpc import bicycle_spec
from ad_mpc_tpu_torch.learned.ensemble import GPEnsemble
from ad_mpc_tpu_torch.learned.gp import GPParams
from ad_mpc_tpu_torch.models.bicycle import BicycleDynamics
from ad_mpc_tpu_torch.models.gp_bicycle import GPBicycleDynamics
from ad_mpc_tpu_torch.models.pacejka import PacejkaDynamics
from ad_mpc_tpu_torch.ocp.solver import BatchedSQPSolver, SolverState

# Quality gates by config (``bench.py:473-478, 493-496``): they describe
# the solution, not the chip, and hold for the port unchanged.
CONFIG_GATES = {
    "c2": {"kkt_mean": 5e-6, "kkt_max": 3e-5, "lat_err_mean_m": 0.4},
    "c3": {"kkt_mean": 5e-6, "kkt_max": 3e-5, "lat_err_mean_m": 0.4},
    "c4": {"kkt_mean": 8e-6, "kkt_max": 1e-4, "lat_err_mean_m": 0.15},
}
RTI_GATES = {"c2": 5e-4, "c4": 7e-4}  # max |u0_RTI - u0_converged|
# c4's window: its fleet cold-starts off the arc, and the stiff tires'
# transient takes some 40 ticks to die out (``bench.py:741-745``).
C4_WARMUP, C4_TICKS = 45, 10
WHEELBASE = 2.7  # of the reference arcs' steering feed-forward [m]

# c2's dynamics: the linear-tire bicycle with the dynamic branch driven
# explicitly by p[0] = 1 (``bench.py:210-213``).
dynamic_bicycle = BicycleDynamics()


def switch_on(v, kappa, extra):
    """c2's and c3's per-scenario parameter: the blend switch at 1."""
    return np.array([1.0], np.float32)


def make_gp_bicycle(n=32):
    """c3's dynamics (``bench.py:216-257``): the dynamic bicycle plus a
    synthetic GP ensemble of one cluster, ``n`` points of 4 features
    (v_x, v_y, psi_dot, delta) for 2 outputs (v_y and psi_dot rows), drawn
    from ``numpy.random.default_rng(11)`` as the JAX bench draws it
    (``n=32``; the JAX tests' small twin takes fewer)."""
    rng = np.random.default_rng(11)
    d = 4
    gps = [[], []]
    for dim in range(2):
        X = rng.uniform([-0.0, -1.0, -0.5, -0.5], [15.0, 1.0, 0.5, 0.5], (n, d))
        y = 0.05 * np.sin(X[:, 1] * 3.0) + 0.02 * X[:, 2] * (dim + 1)
        ls = np.array([5.0, 0.5, 0.3, 0.3])
        sf, sn = 0.01, 0.05
        diff = (X[:, None, :] - X[None, :, :]) / ls
        K = sf * np.exp(-0.5 * np.sum(diff * diff, axis=-1))
        K += (sn**2 + 1e-6) * np.eye(n)
        gps[dim].append(GPParams(
            x_train=X, k_inv_y=np.linalg.solve(K, y - y.mean()), len_scale=ls,
            sigma_f=sf, sigma_n=sn, y_mean=float(y.mean()),
            centroid=X.mean(axis=0)))
    ens = GPEnsemble.from_gps(gps, out_idx=(4, 5), feat_idx=(3, 4, 5, 6))
    return GPBicycleDynamics(ens)


def make_pacejka():
    """c4 (``bench.py:260-298``): the Pacejka bicycle with a per-scenario
    p = [mu, pitch, roll, B scale, D scale] and the friction-circle
    reference-speed cap. Returns (dynamics, p_of_scenario, v_cap)."""
    dyn = PacejkaDynamics()

    def p_of(v, kappa, extra):
        mu = 0.6 + 0.5 * extra[0]  # friction in [0.6, 1.1]
        pitch = (extra[1] - 0.5) * 0.12  # +-3.4 deg
        roll = (extra[2] - 0.5) * 0.10
        b_scale = 0.8 + 0.4 * extra[3]  # stiffness factor draw
        d_scale = 0.85 + 0.3 * extra[4]  # peak factor draw
        return np.array([mu, pitch, roll, b_scale, d_scale], np.float32)

    def v_cap(v, kappa, p):
        """Cap the demanded lateral acceleration v^2 |kappa| at 75% of the
        drawn tire limit mu g D, so that no scenario asks for cornering
        beyond its friction circle."""
        a_y_max = 0.75 * p[:, 0] * 9.81 * p[:, 4]
        v_max = np.sqrt(a_y_max / np.maximum(np.abs(kappa), 1e-3))
        return np.minimum(v, v_max)

    return dyn, p_of, v_cap


def make_scenarios(batch, seed=0):
    """Per-scenario (speed, curvature) as float32 numpy arrays: arcs the
    vehicle can track (|v^2 kappa| <= 6 m/s^2, |kappa| <= 0.05 1/m)."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(5.0, 15.0, batch).astype(np.float32)
    kmax = np.minimum(0.05, 6.0 / v**2)
    kappa = rng.uniform(-1.0, 1.0, batch).astype(np.float32) * kmax
    return v, kappa.astype(np.float32)


def arc_reference(v, kappa, s0, N, dt, wheelbase):
    """(B, N+1, 7) state references along constant-curvature arcs starting
    at arc length s0; v, kappa, s0 are (B,)."""
    ar = torch.arange(N + 1, dtype=torch.float32, device=v.device)
    s = s0[:, None] + v[:, None] * ar * dt
    kap = kappa[:, None]
    straight = kap.abs() < 1e-6
    k = torch.where(straight, torch.full_like(kap, 1e-6), kap)
    psi = k * s
    x = torch.where(straight, s, torch.sin(psi) / k)
    y = torch.where(straight, torch.zeros_like(s), (1.0 - torch.cos(psi)) / k)
    delta = torch.atan(kappa * wheelbase)
    ones = torch.ones_like(s)
    return torch.stack(
        [x, y, psi, v[:, None] * ones, torch.zeros_like(s),
         (kappa * v)[:, None] * ones, delta[:, None] * ones],
        dim=-1,
    )


def _project_arc(x0, s0, kappa):
    """Arc length of the point on each arc closest to its vehicle,
    unwrapped near the previous anchor s0. x0 (B, nx); s0, kappa (B,)."""
    px, py, k = x0[:, 0], x0[:, 1], kappa
    ang = torch.atan2(k * px, 1.0 - k * py)
    ks0 = k * s0
    ang = ks0 + torch.atan2(torch.sin(ang - ks0), torch.cos(ang - ks0))
    straight = k.abs() < 1e-6
    s_arc = ang / torch.where(straight, torch.full_like(k, 1e-6), k)
    return torch.where(straight, px, s_arc)


def draw_p(p_of_scenario, v, kappa):
    """(B, p_dim) float32 parameters, one per scenario (v, kappa), built by
    ``p_of_scenario`` from extras drawn from ``default_rng(1)``, as the JAX
    bench draws them (``bench.py:172-200``)."""
    extras = np.random.default_rng(1).uniform(0.0, 1.0, (len(v), 8)).astype(
        np.float32)
    return np.stack([np.asarray(p_of_scenario(float(vv), float(kk), ee))
                     for vv, kk, ee in zip(v, kappa, extras)]).astype(np.float32)


def pacejka_draw(B):
    """c4's dynamics and the p of B scenarios at v = kappa = 0 (``p_of``
    reads neither), drawn as :func:`build_fleet`'s ``init`` draws them."""
    dyn, p_of, _ = make_pacejka()
    zeros = np.zeros(B, np.float32)
    return dyn, draw_p(p_of, zeros, zeros)


def init_carry(batch, N, p_of_scenario, device, v_cap=None, seed=0):
    """A fleet's first carry (x0, s0, v, kappa, p, states) on ``device``:
    draw (v, kappa), then the extras from ``default_rng(1)``, then p, then
    cap v, the JAX bench's order (``bench.py:172-200``); each vehicle at the
    start of its arc, its warm start the constant state."""
    v, kappa = make_scenarios(batch, seed)
    p_np = draw_p(p_of_scenario, v, kappa)
    if v_cap is not None:
        v = np.minimum(v, v_cap(v, kappa, p_np)).astype(np.float32)
    v = torch.as_tensor(v, device=device)
    x0 = torch.zeros((batch, 7), dtype=torch.float32, device=device)
    x0[:, 3] = v
    states = SolverState(
        xs=x0[:, None].expand(-1, N + 1, -1).contiguous(),
        us=x0.new_zeros((batch, N, 2)),
    )
    return (x0, torch.zeros_like(v), v, torch.as_tensor(kappa, device=device),
            torch.as_tensor(p_np, device=device), states)


def tick_inputs(carry, N, dt):
    """A tick's solve inputs from its carry: the new arc anchor s0 and
    (x0, yref_x, yref_u, p, states), the arguments of the solve."""
    x0, s0, v, kappa, p, states = carry
    s0 = _project_arc(x0, s0, kappa)
    yref_x = arc_reference(v, kappa, s0, N, dt, WHEELBASE)
    yref_u = x0.new_zeros((x0.shape[0], N, 2))
    return s0, (x0, yref_x, yref_u, p, states)


def build_fleet(dynamics, p_of_scenario, n_nodes=30, qp_iters=12,
                sqp_iters=1, v_cap=None, device="cuda", backend="auto"):
    """Closed-loop fleet over :class:`BatchedSQPSolver`.

    dynamics(x, u, p): continuous model with a per-scenario parameter
    vector; p_of_scenario(v, kappa, extra) builds that vector.
    ``v_cap(v, kappa, p)`` (numpy) caps each scenario's speed before it
    reaches the solver. ``backend`` is the solver's (``"cuda"``,
    ``"plain"`` or ``"auto"``).
    Returns (tick, init, solver, spec): tick(carry) -> (carry, (kkt, lat)).
    """
    spec = bicycle_spec(t_horizon=n_nodes * 0.05, n_nodes=n_nodes,
                        qp_iters=qp_iters, sqp_iters=sqp_iters)
    p_dim = int(np.asarray(p_of_scenario(5.0, 0.0, np.zeros(8))).shape[0])
    solver = BatchedSQPSolver(spec, dynamics, p_dim=p_dim, device=device,
                              backend=backend)
    N, dt = spec.n_nodes, spec.dt

    def tick(carry):
        _, _, v, kappa, _, _ = carry
        s0, (x0, yref_x, yref_u, p, states) = tick_inputs(carry, N, dt)
        res = solver.solve(x0, yref_x, yref_u, p, states)
        with torch.no_grad():
            x_next = solver.F(x0, res.us[:, 0], p)
        states = solver.shift(res.state)
        lat = torch.sqrt((x_next[:, 0] - yref_x[:, 1, 0]) ** 2
                         + (x_next[:, 1] - yref_x[:, 1, 1]) ** 2)
        return (x_next, s0, v, kappa, p, states), (res.kkt_residual, lat.mean())

    def init(batch, seed=0):
        return init_carry(batch, N, p_of_scenario, solver.Q.device, v_cap, seed)

    return tick, init, solver, spec


def run_config(tick, init, batch, ticks=20, warmup=5):
    """One measured row on the card: ``warmup`` ticks, then ``ticks`` ticks
    timed with CUDA events around the window and a ``synchronize``."""
    carry = init(batch)
    if carry[0].device.type != "cuda":
        raise RuntimeError("run_config times a CUDA device; the fleet is on "
                           f"{carry[0].device}")
    tic0 = time.perf_counter()
    carry, (kkt, lat) = tick(carry)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - tic0
    for _ in range(warmup - 1):
        carry, (kkt, lat) = tick(carry)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ticks):
        carry, (kkt, lat) = tick(carry)
    end.record()
    torch.cuda.synchronize()
    window_s = start.elapsed_time(end) / 1e3
    row = {
        "solves_per_s": batch * ticks / window_s,
        "tick_ms": 1e3 * window_s / ticks,
        "kkt_mean": float(kkt.mean()),
        "kkt_p99": float(torch.quantile(kkt, 0.99)),
        "kkt_max": float(kkt.max()),
        "lat_err_mean_m": float(lat),
        "batch": batch,
        "warmup_ticks": warmup,
        "measured_ticks": ticks,
        "first_call_s": first_call_s,
    }
    return row, carry


def launches(solver):
    """Kernel launches of ``solver`` so far, by kernel."""
    return {"vde": solver.vde.launches, "lq_ipm": solver.qp.launches,
            "rk4": solver.rk4.launches}


# Launches of each kernel per tick on the cuda backend (one RTI iteration):
# the sweep, the QP, and the RK4 map for the KKT defect and the plant step.
LAUNCHES_PER_TICK = {"vde": 1, "lq_ipm": 1, "rk4": 2}


def rti_vs_converged(dynamics, p_of, carry):
    """Quality gate: max |u0| difference, over the first 64 scenarios,
    between the deployed RTI tick and a converged SQP solve (6 Gauss-Newton
    iterations, 20 IPM iterations) from the same state and warm start."""
    x0, s0, v, kappa, p, states = carry
    m = min(64, x0.shape[0])
    dev = x0.device
    _, _, solver1, spec = build_fleet(dynamics, p_of, qp_iters=12,
                                      sqp_iters=1, device=dev)
    _, _, solver8, _ = build_fleet(dynamics, p_of, qp_iters=20, sqp_iters=6,
                                   device=dev)
    N, dt = spec.n_nodes, spec.dt
    st = SolverState(states.xs[:m].contiguous(), states.us[:m].contiguous())
    s0p = _project_arc(x0[:m], s0[:m], kappa[:m])
    yref_x = arc_reference(v[:m], kappa[:m], s0p, N, dt, WHEELBASE)
    yref_u = x0.new_zeros((m, N, 2))
    u_rti = solver1.solve(x0[:m], yref_x, yref_u, p[:m], st).us[:, 0]
    u_cvg = solver8.solve(x0[:m], yref_x, yref_u, p[:m], st).us[:, 0]
    return float((u_rti - u_cvg).abs().max())


def bench_latency(dynamics, p_of, n_nodes=30, qp_iters=12, reps=30,
                  k_ticks=50, device="cuda"):
    """Single-solve closed-loop latency (batch 1) against the 20 ms budget,
    on the card (port of ``bench.py:382-455``).

    - ``p50_compute``/``p99_compute``: each of ``reps`` samples is
      ``k_ticks`` chained ticks between two CUDA events, divided by K. The
      state stays on the card; at batch 1 the window also holds the gaps
      in which the device waits for the host's launches.
    - ``p50_blocking``/``p99_blocking``: one tick plus a ``synchronize``,
      on the host clock.
    - ``host_link_floor_p50``: a trivial op plus a ``synchronize``.

    ``launches`` counts each kernel's launches over the whole measurement.
    """
    tick, init, solver, _ = build_fleet(dynamics, p_of, n_nodes, qp_iters,
                                        device=device)
    carry = init(1)
    if carry[0].device.type != "cuda":
        raise RuntimeError("bench_latency times a CUDA device; the fleet is "
                           f"on {carry[0].device}")

    def k_tick(c):
        for _ in range(k_ticks):
            c, _aux = tick(c)
        return c

    carry_k = k_tick(carry)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    compute = []
    for _ in range(reps):
        start.record()
        carry_k = k_tick(carry_k)
        end.record()
        end.synchronize()
        compute.append(start.elapsed_time(end) / k_ticks)

    blocking = []
    for _ in range(reps):
        tic = time.perf_counter()
        carry, _aux = tick(carry)
        torch.cuda.synchronize()
        blocking.append(1e3 * (time.perf_counter() - tic))

    x = torch.zeros((1, 8), device=carry[0].device)
    floor = []
    for _ in range(reps):
        tic = time.perf_counter()
        x = x + 1.0
        torch.cuda.synchronize()
        floor.append(1e3 * (time.perf_counter() - tic))

    p50c, p99c = np.percentile(compute, [50, 99])
    p50b, p99b = np.percentile(blocking, [50, 99])
    return {
        "p50_compute": float(p50c),
        "p99_compute": float(p99c),
        "compute_method": f"{k_ticks} chained ticks between CUDA events, "
                          f"/{k_ticks}, {reps} samples",
        "p50_blocking": float(p50b),
        "p99_blocking": float(p99b),
        "host_link_floor_p50": float(np.percentile(floor, 50)),
        "budget": 20.0,
        "launches": launches(solver),
        "ticks": k_ticks * (reps + 1) + reps,
    }
