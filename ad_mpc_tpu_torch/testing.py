"""Seeded numpy problem generators and the LQ kernel's check
(:func:`lq_case`), shared by the tests and ``chip_smoke.py``, and the
tests' :func:`one_thread` fixture.

They draw the same LQ batches and bound structures as the JAX package's
kernel tests (``tests/test_pallas_lq.py:21-67``), so a kernel is checked on
the problems its TPU counterpart was checked on.
"""

from __future__ import annotations

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain versions' small tensors run fastest on one thread, and the
    test workers share the host's cores. A test module takes it by
    ``from ad_mpc_tpu_torch.testing import one_thread``."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_lq(rng, B, N, nx, nu):
    """Batch of random stable LQ problems: float32 A (B,N,nx,nx),
    Bm (B,N,nx,nu), c (B,N,nx), q (B,N+1,nx), r (B,N,nu), u_ref (B,N,nu),
    x_ref (B,N+1,nx)."""
    A = np.eye(nx) + 0.05 * rng.normal(size=(B, N, nx, nx))
    Bm = 0.1 * rng.normal(size=(B, N, nx, nu))
    c = 0.01 * rng.normal(size=(B, N, nx))
    q = rng.normal(size=(B, N + 1, nx))
    r = 0.1 * rng.normal(size=(B, N, nu))
    u_ref = 0.3 * rng.normal(size=(B, N, nu))
    x_ref = 0.3 * rng.normal(size=(B, N + 1, nx))
    return tuple(a.astype(np.float32) for a in (A, Bm, c, q, r, u_ref, x_ref))


def bounds_bicycle_like(nx, nu):
    """Soft input box + one hard state box (the bicycle spec's structure)."""
    u = dict(
        lb=np.array([-10.0, -3.0])[:nu], ub=np.array([5.0, 3.0])[:nu],
        soft=np.ones(nu, bool), zl=np.full(nu, 10.0), zu=np.full(nu, 10.0),
        Zl=np.zeros(nu), Zu=np.zeros(nu),
    )
    lbx, ubx = np.full(nx, -np.inf), np.full(nx, np.inf)
    lbx[-1], ubx[-1] = -0.52, 0.52
    x = dict(lb=lbx, ub=ubx, soft=np.zeros(nx, bool), zl=np.zeros(nx),
             zu=np.zeros(nx), Zl=np.zeros(nx), Zu=np.zeros(nx))
    return u, x


def bounds_hard_unit(nx, nu):
    """[0, 1] hard input box, no state bounds (the quad spec's structure)."""
    u = dict(lb=np.zeros(nu), ub=np.ones(nu), soft=np.zeros(nu, bool),
             zl=np.zeros(nu), zu=np.zeros(nu), Zl=np.zeros(nu), Zu=np.zeros(nu))
    x = dict(lb=np.full(nx, -np.inf), ub=np.full(nx, np.inf),
             soft=np.zeros(nx, bool), zl=np.zeros(nx), zu=np.zeros(nx),
             Zl=np.zeros(nx), Zu=np.zeros(nx))
    return u, x


BOUNDS = {"bicycle": bounds_bicycle_like, "unit": bounds_hard_unit}

# Stage weights of the JAX kernel tests (``tests/test_pallas_lq.py:110-112``).
LQ_WEIGHTS = (np.diag([0.5, 0.5, 2.0, 0.1, 0.0, 0.0, 0.05]),
              np.diag([0.05, 5.0]))
# Quad stage weights for random 13x4 problems: the diagonal of
# ``control.mpc.quad_spec`` times its dt = 0.1 (the terminal weight is ten
# times this, the spec's unscaled diagonal).
QUAD_LQ_WEIGHTS = (0.1 * np.diag([10.0] * 3 + [0.1] * 4 + [0.05] * 6),
                   0.1 * np.diag([0.1] * 4))


def random_traj(rng, B, N, nx, nu, v0=8.0):
    """float32 iterate (xs (B,N+1,nx), us (B,N,nu)) around speed v0, as
    ``tests/test_pallas_vde.py:39-43`` draws it."""
    xs = rng.normal(0.0, 0.4, (B, N + 1, nx)).astype(np.float32)
    xs[:, :, 3] += v0
    us = rng.normal(0.0, 0.5, (B, N, nu)).astype(np.float32)
    return xs, us


def quad_traj(rng, B, N, nx=13, nu=4):
    """float32 quad iterate (xs (B,N+1,13), us (B,N,4)) as
    ``tests/test_pallas_vde.py:124-128`` draws it: states around the
    identity quaternion, inputs in [0, 1]."""
    xs = rng.normal(0.0, 0.3, (B, N + 1, nx)).astype(np.float32)
    xs[:, :, 3] += 1.0  # quaternion w
    us = rng.uniform(0.0, 1.0, (B, N, nu)).astype(np.float32)
    return xs, us


def pacejka_inputs(B, N, device="cuda"):
    """c4's dynamics and the kernels' check inputs: ``random_traj`` from
    ``default_rng(3)`` and p as ``fleet.pacejka_draw`` draws it, as tensors
    (xs, us, ps) on ``device``."""
    import torch

    from ad_mpc_tpu_torch.fleet import pacejka_draw

    dyn, ps = pacejka_draw(B)
    xs, us = random_traj(np.random.default_rng(3), B, N, 7, 2)
    return dyn, [torch.as_tensor(a, device=device) for a in (xs, us, ps)]


def gp_bicycle_inputs(B, N, device="cuda", n=32):
    """c3's dynamics with an ``n``-point ensemble and the kernels' check
    inputs: ``random_traj`` from ``default_rng(3)`` and switch 1."""
    import torch

    from ad_mpc_tpu_torch.fleet import make_gp_bicycle

    xs, us = random_traj(np.random.default_rng(3), B, N, 7, 2)
    ps = np.ones((B, 1), np.float32)
    return make_gp_bicycle(n), [torch.as_tensor(a, device=device)
                                for a in (xs, us, ps)]


SPREAD_RUNS = 8  # perturbed float32 runs of a plain version (lq_case, f64_anchored)
SPREAD_FACTOR = 4.0  # allowance over a correct float32 run (lq_case, f64_anchored, the MXU micro)


def perturbed(args, seed):
    """Copies of the float tensors ``args``, each entry moved by about one
    ulp (relative 2^-23 times a normal draw from ``seed``): inputs on which
    a correct float32 run lands as far from the exact answer as rounding
    may take it."""
    import torch

    gen = torch.Generator(device=args[0].device)
    gen.manual_seed(seed)
    return tuple(a * (1 + 2.0**-23 * torch.randn(a.shape, device=a.device,
                                                 generator=gen)) for a in args)


def table_perturbed(dyn, seed):
    """A copy of the GP dynamics ``dyn`` (a model with ``ensemble`` and
    ``params``) whose training features and weights (``x_train``,
    ``k_inv_y``) are each moved by about one float32 ulp (relative 2^-23
    times a normal draw from ``seed``): the scale at which any float32
    evaluation rounds each term of the GP's sums. Perturbing the inputs
    alone leaves every run of one algorithm with the same rounded terms,
    so its spread can sit far under another float32 algorithm's error.
    A parameter-routed GP (``table_in_p``) reads its table from p, which
    :func:`perturbed` moves: it is returned as it is. A dynamics with
    ``with_ensemble`` (the dual-state and select GP quads) keeps through
    it what it holds beside the ensemble: the RDRv drag, the pinned
    clusters."""
    if getattr(dyn, "table_in_p", False):
        return dyn
    rng = np.random.default_rng(seed)
    ens = dyn.ensemble

    def move(v):
        v = np.asarray(v, np.float64)
        return v * (1 + 2.0**-23 * rng.normal(size=v.shape))

    moved = ens._replace(x_train=move(ens.x_train), k_inv_y=move(ens.k_inv_y))
    if hasattr(dyn, "with_ensemble"):
        return dyn.with_ensemble(moved)
    return type(dyn)(moved, dyn.params)


class _Sequential:
    """A GP quad's plain version (:func:`sequential_sums`) with each GP
    mean's terms summed in the order of the training points."""

    def __init__(self, dyn):
        self.dyn = dyn

    def __call__(self, x, u, p):
        from functools import partial

        from ad_mpc_tpu_torch.learned.lane import (
            add_rows, lane_gp_mean, quad_lane_residual_terms,
            quad_select_residual_terms)
        from ad_mpc_tpu_torch.models.gp_quad import (
            GPQuadDualDynamics, GPQuadSelectDynamics, dual_gp_rows)
        from ad_mpc_tpu_torch.models.quadrotor import quad_dynamics_lane

        d, mean = self.dyn, partial(lane_gp_mean, sequential=True)
        if isinstance(d, GPQuadSelectDynamics):
            return add_rows(d._nominal(x, u), quad_select_residual_terms(
                d.ensemble, x, d.pin, mean=mean))
        if isinstance(d, GPQuadDualDynamics):
            return add_rows(d._nominal(x, u), dual_gp_rows(d.ensemble, x, p, mean=mean))
        return add_rows(quad_dynamics_lane(x, u, None, d.params),
                        quad_lane_residual_terms(d.ensemble, x, mean=mean))


def sequential_sums(dyn):
    """The plain version of the GP quad ``dyn`` (``GPQuadDynamics``,
    ``GPQuadDualDynamics`` or ``GPQuadSelectDynamics``) with each GP mean's
    terms summed one after another in the order of the training points
    (``lane_gp_mean(sequential=True)``), as the kernels' ``gp_table_mean``
    sums them, where the plain version sums by ``torch.sum``: another
    float32 algorithm for the same function, whose rounding of a sum of
    large, cancelling terms (the fitted models' 60 terms of up to 3,657
    that sum to under 6) reaches where that of ``torch.sum``'s order on
    perturbed inputs does not. None for any other dynamics."""
    from ad_mpc_tpu_torch.models.gp_quad import (
        GPQuadDualDynamics, GPQuadDynamics, GPQuadSelectDynamics)

    kinds = (GPQuadDynamics, GPQuadDualDynamics, GPQuadSelectDynamics)
    return _Sequential(dyn) if isinstance(dyn, kinds) else None


def _anchored_terms(got, runs32, plain64, atol, rows):
    """(|got - plain64|, the float32 spread s, |got - plain64| - atol
    clamped at 0), by rows (the last axis) where ``rows`` says so."""
    import torch

    def by_row(t):
        return t.amax(-1) if rows else t

    err = by_row((got.double() - plain64).abs())
    spread = by_row(torch.stack([(m.double() - plain64).abs()
                                 for m in runs32]).amax(0))
    return err, spread, (err - atol).clamp(min=0)


def _anchored_verdict(got, err, spread, over):
    import torch

    ratio = torch.where(over > 0, over / spread, torch.zeros_like(over))
    ok = bool(got.isfinite().all()) and bool((over <= SPREAD_FACTOR * spread).all())
    return float(err.max()), float(spread.max()), float(ratio.max()), ok


def f64_anchored(got, runs32, plain64, atol, rows=False):
    """A float32 answer ``got`` held to the float64 plain answer
    ``plain64`` entry by entry,
        |got - plain64| <= atol + SPREAD_FACTOR * s,
    s the entry's float32 spread: the largest |m - plain64| over the
    float32 plain answers ``runs32`` (the plain version on the inputs and
    on ``SPREAD_RUNS`` copies from :func:`perturbed`, its GP table from
    :func:`table_perturbed`). With ``rows`` the
    rule holds per row of a matrix (the last axis): the row's largest
    error against its largest spread. An entry or row that float32
    computes well is so held near ``atol``, whatever the spread beside it.
    The rule for a function whose float32 rounding alone moves it beyond
    ``atol`` (the fitted GP-quad, whose 60 terms of up to 2,755 sum to a
    mean under 6). Returns (max |got - plain64|, max s, the largest ratio
    (|got - plain64| - atol) / s over the entries or rows, 0 where within
    atol, whether the rule holds)."""
    return _anchored_verdict(got, *_anchored_terms(got, runs32, plain64, atol, rows))


def anchored_hold(got, plain, dyn, args, atol, rows):
    """Each output of ``got`` held by :func:`f64_anchored` (by rows where
    ``rows`` says so) against the float64 answer of ``plain(dyn, *args)``
    (outputs and ``args`` with the scenarios leading), with the spread of
    its float32 answers on ``args`` and on ``SPREAD_RUNS`` copies of the
    inputs and of the GP table each moved by about an ulp
    (:func:`perturbed`, :func:`table_perturbed`). Where a scenario breaks
    the rule under those runs, which all sum each GP mean in
    ``torch.sum``'s order, and the dynamics has a plain version that sums
    in the kernels' order (:func:`sequential_sums`), that scenario's spread
    also takes the runs of that order on the same inputs and copies:
    float32's reach on a sum of large, cancelling terms depends on the
    order of the sum, and a spread of one order undercounts another's (on
    ``gp_flagship_c2``'s select sweep a row lay 7 spreads out). Returns
    ([(max |got - plain64|, max s, the largest ratio, whether the rule
    holds) per output], the float32 plain answer on ``args``, the
    scenarios that took the sequential runs)."""
    import torch

    want64 = plain(dyn, *(a.double() for a in args))
    runs = [plain(dyn, *args)] + [
        plain(table_perturbed(dyn, s), *perturbed(args, s)) for s in range(SPREAD_RUNS)]
    terms = [_anchored_terms(g, [r[i] for r in runs], w64, atol, by_rows)
             for i, (g, w64, by_rows) in enumerate(zip(got, want64, rows))]
    bad = torch.zeros(args[0].shape[0], dtype=torch.bool, device=args[0].device)
    for g, (err, spread, over) in zip(got, terms):
        off = (over > SPREAD_FACTOR * spread) | ~(err == err)
        bad |= off.reshape(off.shape[0], -1).any(1)
    idx = bad.nonzero().flatten()
    if len(idx) and sequential_sums(dyn) is not None:
        sub = lambda t: tuple(a[idx] for a in t)
        seq = [plain(sequential_sums(dyn), *sub(args))] + [
            plain(sequential_sums(table_perturbed(dyn, s)), *sub(perturbed(args, s)))
            for s in range(SPREAD_RUNS)]
        for i, (err, spread, over) in enumerate(terms):
            s_seq = _anchored_terms(got[i][idx], [r[i] for r in seq], want64[i][idx],
                                    atol, rows[i])[1]
            spread[idx] = torch.maximum(spread[idx], s_seq)
    else:
        idx = idx[:0]
    return ([_anchored_verdict(g, *t) for g, t in zip(got, terms)], runs[0],
            idx.tolist())


# |a - b| of two functors' RK4 maps that compute one function (rk4_pair):
# the fitted GP-quad's float32 rounding moves a step by up to about 7e-5
# (on an H100 and on the CPU), a wrong GP or cluster by 1e-2 and more.
RK4_PAIR_TOL = 1e-4


def rk4_pair(dyn_a, p_a, dyn_b, p_b, x, u, dt):
    """The RK4 maps (``make_rk4``, one step) of two dynamics that compute
    one function, such as a GP baked into its functor and the same GP
    routed through p, on the same states x (B, nx) and inputs u (B, nu).
    Each is held to the float64 plain version of ``dyn_a`` by
    :func:`f64_anchored` (atol 3e-5), the spread taken over the float32
    plain versions of both on :func:`perturbed` inputs and
    :func:`table_perturbed` tables. Returns (max |a - b|, its error
    against the float64 plain version for a and for b, max spread, both
    held)."""
    from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4
    from ad_mpc_tpu_torch.ops.integrators import discrete_step

    nx, nu = x.shape[1], u.shape[1]
    pairs = ((dyn_a, p_a), (dyn_b, p_b))
    got = [make_rk4(d, dt, nx, nu, p.shape[1], device=x.device)(x, u, p)
           for d, p in pairs]
    want64 = discrete_step(dyn_a, dt, 1, x.double(), u.double(), p_a.double())
    runs = [discrete_step(d, dt, 1, x, u, p) for d, p in pairs] + [
        discrete_step(table_perturbed(d, s), dt, 1, *perturbed((x, u, p), s))
        for d, p in pairs for s in range(SPREAD_RUNS)]
    held = [f64_anchored(g, runs, want64, 3e-5) for g in got]
    return (float((got[0] - got[1]).abs().max()), held[0][0], held[1][0],
            max(h[1] for h in held), held[0][3] and held[1][3])


# Scenarios of an LQ case that ``lq_case`` also solves on the CPU.
CONTROL_SCENARIOS = 2048


def lq_case(qp, args, strict):
    """Hold the LQ kernel against its plain version on one batch, scenario
    by scenario, at atol 3e-4 / rtol 1e-3 on dx and du.

    Where a problem is ill-conditioned, 12 float32 IPM iterations are not
    reproducible between two correct implementations: the fraction-to-
    boundary step is a min over ratios, so rounding moves the path. The
    float64 run of the plain version is the exact answer, and each scenario
    b gets an allowance from its own float32 spread s_b: the largest
    max |m - f64| over float32 runs m of the plain version, on the inputs
    and on ``SPREAD_RUNS`` copies perturbed by about one ulp. Every scenario
    must satisfy
        max (|kernel - f64| - (atol + rtol |f64|)) <= SPREAD_FACTOR * s_b,
    so a well-conditioned scenario (s_b ~ 1e-6) is held to the tolerance.
    ``factor`` is the least factor that passes. ``fixed_tol_misses``
    counts the scenarios that a rule with no allowance would reject: off
    the float32 plain version and off the float64 answer where the float32
    plain version hits it. ``control_*`` are the same two numbers for the
    plain version run on the CPU, a correct float32 implementation by
    construction, on the first ``CONTROL_SCENARIOS`` scenarios (a printed
    comparison, not a gate: at B=16384 the CPU run took 19 s of an 8-core
    host per case). ``strict`` (the main path's QPs) also
    asks every scenario to agree with the float32 plain version. Every
    output is finite, alpha lies in [0, 1], and a second launch gives the
    same bits.
    """
    import torch

    plain = lambda: qp.plain(*args)
    got, again, want = qp(*args), qp(*args), plain()
    ref64 = qp.plain(*(a.double() for a in args))
    B = args[0].shape[0]
    n_ctl = min(B, CONTROL_SCENARIOS)
    control = qp.plain(*(a[:n_ctl].cpu() for a in args))
    runs = [want] + [qp.plain(*perturbed(args, seed)) for seed in range(SPREAD_RUNS)]
    torch.cuda.synchronize()

    def excess(g, w):  # per scenario: how far dx, du lie outside tolerance of w
        return torch.stack([
            ((a.double().to(b.device) - b.double()).abs()
             - (3e-4 + 1e-3 * b.double().abs())).flatten(1).amax(1)
            for a, b in zip(g[:2], w[:2])]).amax(0)

    spread = torch.stack([torch.stack([
        (a.double() - b.double()).abs().flatten(1).amax(1)
        for a, b in zip(m[:2], ref64[:2])]).amax(0) for m in runs]).amax(0)

    first = lambda out, n: [t[:n] for t in out[:2]]

    def factor(g, n=B):  # over the first n scenarios
        e = excess(g, first(ref64, n)).to(spread.device)
        need = torch.where(e > 0, e / spread[:n], torch.zeros_like(e))
        return float(need.amax())

    plain_hits64 = excess(want, ref64) <= 0

    def fixed_tol_misses(g, n=B):
        off = (excess(g, first(want, n)) > 0) & (excess(g, first(ref64, n)) > 0)
        return int((off.to(plain_hits64.device) & plain_hits64[:n]).sum())

    agree = excess(got, want) <= 0
    row = {
        "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2])),
        "agree": int(agree.sum()), "B": B,
        "kernel_misses_f64": int((excess(got, ref64) > 0).sum()),
        "plain_misses_f64": int(B - plain_hits64.sum()),
        "factor": factor(got), "control_factor": factor(control, n_ctl),
        "fixed_tol_misses": fixed_tol_misses(got),
        "control_fixed_tol_misses": fixed_tol_misses(control, n_ctl),
        "control_B": n_ctl,
        "deterministic": all(torch.equal(g, h) for g, h in zip(got, again)),
    }
    ok = (row["factor"] <= SPREAD_FACTOR and row["deterministic"]
          and (row["agree"] == B or not strict)
          and all(bool(g.isfinite().all()) for g in got)
          and bool(((got[2] >= 0) & (got[2] <= 1)).all()))
    return row, ok, plain


def bike_instance(rng, N, dt, switch=None):
    """One single-vehicle bicycle problem (x0 (7,), yref_x (N+1,7),
    yref_u (N,2), p (1,)), float64 numpy, as ``tests/test_acados_parity.py
    :_random_bike_instance`` draws it: an arc at 5-14 m/s with a lateral
    offset, the car perturbed around its start. p is the blend switch at
    x0's speed, 0 at these speeds, or ``switch``."""
    from ad_mpc_tpu_torch.models.bicycle import BicycleParams, blend_switch

    v = rng.uniform(5.0, 14.0)
    kmax = min(0.05, 6.0 / v**2)
    kappa = rng.uniform(-1.0, 1.0) * kmax
    s = v * np.arange(N + 1) * dt
    if abs(kappa) > 1e-6:
        x, y, psi = np.sin(kappa * s) / kappa, (1 - np.cos(kappa * s)) / kappa, kappa * s
    else:
        x, y, psi = s, np.zeros_like(s), np.zeros_like(s)
    yref = np.zeros((N + 1, 7))
    yref[:, 0] = x
    yref[:, 1] = y + rng.uniform(-1.5, 1.5)  # lateral offset
    yref[:, 2] = psi
    yref[:, 3] = v
    x0 = np.zeros(7)
    x0[0] = rng.uniform(-0.5, 0.5)
    x0[1] = rng.uniform(-0.5, 0.5)
    x0[2] = rng.uniform(-0.15, 0.15)
    x0[3] = v * rng.uniform(0.85, 1.15)
    x0[4] = rng.uniform(-0.3, 0.3)
    x0[5] = rng.uniform(-0.2, 0.2)
    x0[6] = rng.uniform(-0.3, 0.3)
    p = np.array([blend_switch(float(x0[3]), BicycleParams())
                  if switch is None else switch])
    return x0, yref, np.zeros((N, 2)), p


def rti_oracle_distance(path, device, backend="auto", solves=30):
    """max |u0 - u0_oracle| after ``solves`` RTI re-solves without shift on
    the committed oracle instance at ``path`` (npz: x0, yref, yref_u,
    params, us_oracle; N=20, dt=0.05), in float32, with the spec of
    ``tests/test_acados_parity.py:test_rti_converges_to_oracle`` (one
    Gauss-Newton iteration, 40 IPM iterations). Returns (distance, the
    solver's kernel launches)."""
    import dataclasses

    import torch

    from ad_mpc_tpu_torch.control.mpc import bicycle_spec
    from ad_mpc_tpu_torch.models.bicycle import BicycleDynamics
    from ad_mpc_tpu_torch.ocp.solver import SQPSolver

    with np.load(path) as z:
        fix = {k: z[k] for k in z.files}
    N = fix["yref_u"].shape[0]
    spec = dataclasses.replace(
        bicycle_spec(t_horizon=0.05 * N, n_nodes=N, sqp_iters=25, qp_iters=40),
        sqp_iters=1)
    solver = SQPSolver(spec, BicycleDynamics(), p_dim=1, device=device,
                       backend=backend)
    t = lambda k: torch.as_tensor(fix[k], dtype=torch.float32, device=device)
    x0, yref, yref_u, params = t("x0"), t("yref"), t("yref_u"), t("params")
    state = solver.init_state(x0)
    for _ in range(solves):
        res = solver.solve(x0, yref, yref_u, params, state)
        state = res.state  # no shift: the problem is fixed
    d = float(np.max(np.abs(res.us[0].double().cpu().numpy() - fix["us_oracle"][0])))
    launches = {"vde": solver.vde.launches, "lq_ipm": solver.qp.launches,
                "rk4": solver.rk4.launches}
    return d, launches


def fleet_oracle_distance(path, device, backend="auto", solves=30):
    """max |u0 - u0_oracle| after ``solves`` RTI re-solves without shift on
    the committed oracle instance at ``path`` through the fleet solver
    (:class:`BatchedSQPSolver`) at the deployed c2 settings: one
    Gauss-Newton iteration, 12 IPM iterations, float32, the fixture's
    horizon (N=20, dt=0.05 s, ``fleet.build_fleet``'s spec) and its p
    broadcast as the fleet's per-scenario row, from the fleet's cold start.
    Returns (distance, the solver's kernel launches)."""
    import torch

    from ad_mpc_tpu_torch.control.mpc import bicycle_spec
    from ad_mpc_tpu_torch.models.bicycle import BicycleDynamics
    from ad_mpc_tpu_torch.ocp.solver import BatchedSQPSolver

    with np.load(path) as z:
        fix = {k: z[k] for k in z.files}
    N = fix["yref_u"].shape[0]
    spec = bicycle_spec(t_horizon=0.05 * N, n_nodes=N, qp_iters=12, sqp_iters=1)
    solver = BatchedSQPSolver(spec, BicycleDynamics(), p_dim=1, device=device,
                              backend=backend)
    t = lambda k: torch.as_tensor(fix[k], dtype=torch.float32, device=device)[None]
    x0, yref, yref_u, params = t("x0"), t("yref"), t("yref_u"), t("params")
    state = solver.init_state(x0)
    for _ in range(solves):
        res = solver.solve(x0, yref, yref_u, params, state)
        state = res.state  # no shift: the problem is fixed
    d = float(np.max(np.abs(res.us[0, 0].double().cpu().numpy()
                            - fix["us_oracle"][0])))
    launches = {"vde": solver.vde.launches, "lq_ipm": solver.qp.launches,
                "rk4": solver.rk4.launches}
    return d, launches


def dual_gp_ps(rng, B, ens, trigger_every=10):
    """(B, 1+2D) float32 parameter rows of the dual-state GP quad
    ``[trigger, mu0 (D), cluster (D)]`` for the ensemble ``ens``: the
    trigger on every ``trigger_every``-th row (node 0 of each horizon in
    the one-stage route), mu0 in [-1, 1], clusters drawn among the
    ensemble's."""
    D, C = len(ens.out_idx), ens.n_clusters
    p = np.zeros((B, 1 + 2 * D), np.float32)
    p[::trigger_every, 0] = 1.0
    p[:, 1:1 + D] = rng.uniform(-1.0, 1.0, (B, D))
    p[:, 1 + D:] = rng.integers(0, C, (B, D))
    return p


def tie_gap(centroids, z):
    """How far the features z lie from a tie of their two nearest
    centroids, entrywise: (d2_second - d2_best) / (d2_second + d2_best) of
    ``lane.centroid_dists``, 0 at a tie, up to 1."""
    import torch

    from ad_mpc_tpu_torch.learned.lane import centroid_dists

    d2, _ = torch.sort(torch.stack(centroid_dists(centroids, z)), dim=0)
    return (d2[1] - d2[0]) / (d2[1] + d2[0])


class _Chosen:
    """A select dynamics (``GPQuadSelectDynamics``) whose plain version
    picks among the clusters by ``choose`` (``lane.nearest_mean``'s
    signature), for the checks near cluster boundaries."""

    def __init__(self, dyn, choose):
        self.dyn, self.choose = dyn, choose

    def __call__(self, x, u, p):
        from ad_mpc_tpu_torch.learned.lane import add_rows, quad_select_residual_terms

        d = self.dyn
        return add_rows(d._nominal(x, u), quad_select_residual_terms(
            d.ensemble, x, d.pin, choose=self.choose))


def select_tie_gaps(dyn, dt, xs, us):
    """(B,) the smallest :func:`tie_gap` over every evaluation of every
    output's cluster choice in the RK4 maps of each scenario's stages, for
    the select dynamics ``dyn`` on xs (B, N+1, 13), us (B, N, 4), in
    float64 (inf where the clusters are pinned): the states at which the
    kernel and the plain version could pick different clusters by rounding
    lie near 0."""
    import torch

    from ad_mpc_tpu_torch.learned.lane import nearest_mean
    from ad_mpc_tpu_torch.ops.integrators import discrete_step

    gaps = []

    def choose(centroids, means, z):
        gaps.append(tie_gap(centroids, z))
        return nearest_mean(centroids, means, z)

    x, u = xs[:, :-1].double(), us.double()
    discrete_step(_Chosen(dyn, choose), dt, 1, x, u, x.new_zeros(x.shape[:-1] + (0,)))
    if not gaps:  # pinned clusters: no choice is made
        return torch.full((xs.shape[0],), float("inf"), dtype=x.dtype, device=x.device)
    return torch.stack(gaps).reshape(len(gaps), xs.shape[0], -1).amin(dim=(0, 2))


def margin_quad_traj(rng, B, N, dyns, dt, margin=1e-4, v_scale=5.0, device="cpu"):
    """A float32 quad iterate as :func:`quad_traj` draws it, its
    velocities scaled by ``v_scale`` (so that they span the clusters), of
    the B scenarios whose every cluster choice for each select dynamics of
    ``dyns`` (one, or a list) lies at least ``margin`` from a tie
    (:func:`select_tie_gaps`, run on ``device``), drawn in rounds."""
    import torch

    dyns = dyns if isinstance(dyns, (list, tuple)) else [dyns]
    keep_x, keep_u, n = [], [], 0
    while n < B:
        xs, us = quad_traj(rng, B, N)
        xs[..., 7:10] *= v_scale
        xt, ut = (torch.as_tensor(a, device=device) for a in (xs, us))
        gaps = torch.stack([select_tie_gaps(d, dt, xt, ut) for d in dyns]).amin(0)
        ok = (gaps >= margin).cpu().numpy()
        keep_x.append(xs[ok])
        keep_u.append(us[ok])
        n += int(ok.sum())
    return np.concatenate(keep_x)[:B], np.concatenate(keep_u)[:B]


# The select sweep's draw on which one row of gp_flagship_c2's sweep once
# lay 7.02 float32 spreads of torch.sum's order from the float64 plain
# version (the kernel sums each mean in the points' order): the drag-free
# draws of chip_smoke.py's select phase when the drag case's tie margins
# also filtered them (seed 13, B=16384, N=10), and its scenarios that broke
# the check.
SELECT_DRAW_SEED = 13
SELECT_DRAW_SCENARIOS = (3146,)


def select_draw(device, B=16384, N=10):
    """(the select dynamics of ``gp_flagship_c2``, xs, us) of the draw
    above: :func:`margin_quad_traj` filtered by the tie margins of that
    model, of the synthetic two-cluster ensemble and of ``gp_flagship_c2``
    with the fitted RDRv drag, on ``device``."""
    import torch

    from ad_mpc_tpu_torch.experiments import quad_fleet
    from ad_mpc_tpu_torch.models.gp_quad import GPQuadSelectDynamics

    c2 = quad_fleet.fitted_ensemble_c2()
    dyn = GPQuadSelectDynamics(c2)
    filt = [dyn, GPQuadSelectDynamics(quad_fleet.make_quad_gp_ensemble(clusters=2)),
            GPQuadSelectDynamics(c2, rdrv_d=quad_fleet.fitted_rdrv_d())]
    xs, us = margin_quad_traj(np.random.default_rng(SELECT_DRAW_SEED), B, N, filt, 0.1,
                              device=device)
    return dyn, torch.as_tensor(xs, device=device), torch.as_tensor(us, device=device)


def boundary_quad_states(rng, B, ens, offset=1e-6):
    """(x (B, 13), u (B, 4)) float32: level-ish attitudes, inputs in
    [0, 1], and body velocities on the plane between the first two
    centroids of the ensemble's first output, moved off it by ``offset``
    times a normal draw along its normal and spread within it: the states
    at which the kernel's cluster choice (on its own rounding of R(q)^T v)
    and the plain version's may differ."""
    c0, c1 = (np.asarray(ens.centroids[0, c], np.float64) for c in (0, 1))
    n = (c1 - c0) / np.linalg.norm(c1 - c0)
    a = np.cross(n, [1.0, 0.0, 0.0] if abs(n[0]) < 0.9 else [0.0, 1.0, 0.0])
    a /= np.linalg.norm(a)
    b = np.cross(n, a)
    s, t = rng.uniform(-1.5, 1.5, (2, B))
    vb = 0.5 * (c0 + c1) + s[:, None] * a + t[:, None] * b
    vb += offset * np.linalg.norm(c1 - c0) * rng.normal(size=(B, 1)) * n
    import torch

    from ad_mpc_tpu_torch.learned.lane import _rot_rows

    x = np.zeros((B, 13))
    x[:, :3] = rng.normal(0.0, 1.0, (B, 3))
    q = np.concatenate([np.ones((B, 1)), rng.normal(0.0, 0.1, (B, 3))], axis=1)
    x[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x[:, 10:13] = rng.normal(0.0, 0.3, (B, 3))
    R = _rot_rows(torch.as_tensor(x.T))  # v = R(q) v_b
    x[:, 7:10] = np.stack([sum(R[r][k].numpy() * vb[:, k] for k in range(3))
                           for r in range(3)], axis=1)
    u = rng.uniform(0.0, 1.0, (B, 4))
    return x.astype(np.float32), u.astype(np.float32)


def tie_flipped(dyn, rel=1e-4):
    """The plain version of the select dynamics ``dyn`` with every cluster
    choice that lies within ``rel`` of a tie (:func:`tie_gap`) flipped to
    the other of the two nearest centroids: at a state on a boundary, the
    kernel's answer is the plain version's or this one's."""
    import torch

    from ad_mpc_tpu_torch.learned.lane import centroid_dists

    def choose(centroids, means, z):
        d2 = torch.stack(centroid_dists(centroids, z))
        order = torch.argsort(d2, dim=0, stable=True)
        m = torch.stack(list(means))
        first, second = (torch.gather(m, 0, order[i:i + 1])[0] for i in (0, 1))
        return torch.where(tie_gap(centroids, z) < rel, second, first)

    return _Chosen(dyn, choose)


def routed_bicycle_ensemble(seed=4, n=6, d=4):
    """The two-cluster ensemble on the bicycle layout (outputs rows 4 and
    5, features x[3..6]) of the JAX package's routed-GP test
    (``tests/test_pallas_vde.py:263-282``): cluster c's points uniform in
    [-1, 1]^d shifted by 3c, the same draws and solves."""
    from ad_mpc_tpu_torch.learned.ensemble import GPEnsemble
    from ad_mpc_tpu_torch.learned.gp import GPParams

    rng = np.random.default_rng(seed)
    gps = [[], []]
    for dim in range(2):
        for c in range(2):
            X = rng.uniform(-1, 1, (n, d)) + 3.0 * c
            y = 0.1 * X[:, 0] + 0.05 * c
            ls = np.full(d, 1.5)
            K = 0.2 * np.exp(-0.5 * np.sum(((X[:, None] - X[None]) / ls) ** 2,
                                           axis=-1)) + 1e-3 * np.eye(n)
            gps[dim].append(GPParams(X, np.linalg.solve(K, y - y.mean()), ls, 0.2,
                                     0.03, float(y.mean()), X.mean(axis=0)))
    return GPEnsemble.from_gps(gps, out_idx=(4, 5), feat_idx=(3, 4, 5, 6))


def routed_bicycle_inputs(B, N, device, seed=5):
    """(dynamics, xs, us, ps) of the routed GP bicycle on its test
    ensemble: c2's trajectory draws (``random_traj``, v_x about 8 m/s, where
    the bicycle's 1 / v_x leaves float32 well conditioned), each scenario's
    p the switch 1 and a cluster's GP: packed at its first state's features
    (cluster 1) for odd scenarios, at the origin (cluster 0) for even
    ones."""
    import torch

    from ad_mpc_tpu_torch.learned.lane import param_residual_dynamics
    from ad_mpc_tpu_torch.models.bicycle import BicycleDynamics

    ens = routed_bicycle_ensemble()
    dyn, _, pack = param_residual_dynamics(ens, BicycleDynamics(), 1)
    xs, us = (torch.as_tensor(a, device=device)
              for a in random_traj(np.random.default_rng(seed), B, N, 7, 2))
    z = xs[:, 0, 3:7].clone()
    z[::2] = 0.0
    ps = pack(z, torch.ones(1))
    return dyn, xs, us, ps


def routed_quad_inputs(ens, B, N, seed, device):
    """(dynamics, xs, us, ps, the clusters ps name) of the routed
    body-frame GP of ``ens`` on ``quad_traj``'s draws: each scenario's p
    packed at its first body velocity moved to the centroid of cluster b
    mod C, so that a launch holds every cluster."""
    import torch

    from ad_mpc_tpu_torch.experiments.routed_fleet import body_velocities
    from ad_mpc_tpu_torch.learned.lane import param_residual_dynamics
    from ad_mpc_tpu_torch.models.quadrotor import QuadDynamics

    dyn, _, pack = param_residual_dynamics(ens, QuadDynamics(), 0, quad_frame=True)
    xs, us = (torch.as_tensor(a, device=device)
              for a in quad_traj(np.random.default_rng(seed), B, N))
    cen = torch.as_tensor(np.asarray(ens.centroids)[0], dtype=torch.float32, device=device)
    z = body_velocities(xs[:, 0]) + cen[torch.arange(B, device=device) % ens.n_clusters]
    return dyn, xs, us, pack(z), sorted(set(pack.clusters(z).flatten().tolist()))


def mission_host_syncs(node, n_msgs):
    """Step the mission ``node`` (its MPC on the card) through ``n_msgs``
    hover messages with every host synchronisation a warning. Returns
    (the node's fetches, QuadMPC's watchdog fetches, {site: count} of the
    rest, optimized messages)."""
    import collections
    import inspect
    import os
    import warnings

    import torch

    from ad_mpc_tpu_torch.control import mpc as mpc_mod
    from ad_mpc_tpu_torch.nodes import quad_node

    src, first = inspect.getsourcelines(mpc_mod.QuadMPC.optimize)
    watchdog = {first + i for i, line in enumerate(src) if "float(self._health" in line}
    x = np.zeros(13)
    x[2], x[3] = 1.0, 1.0
    n0 = node.n_optimized
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            for k in range(n_msgs):
                node.step(x, 0.02 * k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter((os.path.abspath(w.filename), w.lineno) for w in ws
                                if "synchroniz" in str(w.message))
    node_file = os.path.abspath(quad_node.__file__)
    mpc_file = os.path.abspath(mpc_mod.__file__)
    fetch = sum(n for (f, _), n in sites.items() if f == node_file)
    wd = sum(n for (f, ln), n in sites.items() if f == mpc_file and ln in watchdog)
    rest = {f"{os.path.basename(f)}:{ln}": n for (f, ln), n in sites.items()
            if f != node_file and not (f == mpc_file and ln in watchdog)}
    return fetch, wd, rest, node.n_optimized - n0


def c2_tick_reference(B, device):
    """The single-process c2 tick (``fleet.build_fleet``) at batch B on
    ``device``: {u0 of its solve, the shifted warm start (next_xs,
    next_us), the plant step x_next, the KKT mean in float64}, host arrays.
    ``tick`` does not return u0: it is the u0 of the same solve re-run on
    the same inputs (the kernels are deterministic; the KKT bits are
    checked)."""
    import torch

    from ad_mpc_tpu_torch import fleet

    tick, init, solver, spec = fleet.build_fleet(fleet.dynamic_bicycle,
                                                 fleet.switch_on, device=device)
    carry = init(B)
    (x_next, _s, _v, _k, _p, nxt), (kkt, _lat) = tick(carry)
    _s0, args = fleet.tick_inputs(carry, spec.n_nodes, spec.dt)
    res = solver.solve(*args)
    if not torch.equal(res.kkt_residual, kkt):
        raise RuntimeError("c2 tick: the re-solve's bits differ from the tick's")
    host = lambda t: t.cpu().numpy()
    return {"u0": host(res.us[:, 0]), "next_xs": host(nxt.xs), "next_us": host(nxt.us),
            "x_next": host(x_next), "kkt_mean": float(kkt.double().mean())}
