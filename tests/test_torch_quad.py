"""Port parity for the c5 quadrotor path: quaternion helpers, the quad
model, the VDE sweep and RK4 map with ``p_dim=0``, the 13x4 QP (the
stage-unrolled ``_lq_kernel``'s shape), the scenario draws and the fleet.

Every input is drawn from a seed with numpy and handed to both packages;
the JAX side runs on the CPU (the Pallas kernels in interpret mode).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from ad_mpc_tpu.control.mpc import bicycle_spec as jax_bicycle_spec
from ad_mpc_tpu.control.mpc import quad_spec as jax_quad_spec
from ad_mpc_tpu.experiments import quad_fleet as jax_quad_fleet
from ad_mpc_tpu.models import quadrotor as jq
from ad_mpc_tpu.ocp.solver import BatchedSQPSolver as JaxBatchedSQPSolver
from ad_mpc_tpu.ocp.solver import SolverState as JaxSolverState
from ad_mpc_tpu.ops.integrators import discretize, linearize
from ad_mpc_tpu.ops.pallas_lq import make_lq_solver as jax_make_lq_solver
from ad_mpc_tpu.ops.pallas_vde import make_vde as jax_make_vde
from ad_mpc_tpu.utils import math as jm
from ad_mpc_tpu_torch import bench, convert
from ad_mpc_tpu_torch.experiments import quad_fleet
from ad_mpc_tpu_torch.models import quadrotor as tq
from ad_mpc_tpu_torch.ocp.solver import BatchedSQPSolver, SolverState
from ad_mpc_tpu_torch.ops import cuda_lq
from ad_mpc_tpu_torch.ops.cuda_lq import lq_geometry, make_lq_solver
from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4, make_vde
from ad_mpc_tpu_torch.testing import BOUNDS, QUAD_LQ_WEIGHTS, quad_traj, random_lq
from ad_mpc_tpu_torch.utils import math as tm
from ad_mpc_tpu_torch.testing import one_thread  # noqa: F401 (autouse)


DT = 0.1
_QP = jq.QuadrotorParams()


def _jax_quad(x, u, p):
    return jq.quad_dynamics_lane(x, u, p, _QP)


def _draw_states(seed=9, n=64):
    """``tests/test_pallas_vde.py:98-102``: half the quaternions unit."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 0.7, (n, 13)).astype(np.float32)
    x[: n // 2, 3:7] /= np.linalg.norm(x[: n // 2, 3:7], axis=1, keepdims=True)
    u = rng.uniform(0.0, 1.0, (n, 4)).astype(np.float32)
    return x, u


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(8, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.normal(size=(8, 3)).astype(np.float32)
    qt, vt = torch.as_tensor(q), torch.as_tensor(v)
    for got, want in (
        (tm.skew_symmetric(vt), jm.skew_symmetric(v)),
        (tm.q_to_rot_mat(qt), jm.q_to_rot_mat(q)),
        (tm.v_dot_q(vt, qt), jm.v_dot_q(v, q)),
        (tm.quaternion_inverse(qt), jm.quaternion_inverse(q)),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("rdrv", [False, True], ids=["nominal", "rdrv"])
def test_quad_dynamics_match_jax(rdrv):
    x, u = _draw_states()
    D = np.diag([0.3, 0.4, 0.1]) if rdrv else None
    got = vmap(lambda xx, uu: tq.quad_dynamics(xx, uu, tq.QuadrotorParams(), D))(
        torch.as_tensor(x), torch.as_tensor(u))
    want = jax.vmap(lambda xx, uu: jq.quad_dynamics(xx, uu, _QP, D))(x, u)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_quad_lane_form_matches_jax_and_matrix_form():
    x, u = _draw_states()
    lane = tq.quad_dynamics_lane(torch.as_tensor(x.T), torch.as_tensor(u.T)).T
    want = jax.vmap(lambda xx, uu: jq.quad_dynamics_lane(xx, uu, None, _QP))(x, u)
    np.testing.assert_allclose(lane.numpy(), np.asarray(want), atol=1e-5)
    mat = vmap(lambda xx, uu: tq.quad_dynamics(xx, uu))(torch.as_tensor(x),
                                                      torch.as_tensor(u))
    # f32: the two forms associate differently (test_pallas_vde.py:110).
    np.testing.assert_allclose(lane.numpy(), mat.numpy(), atol=1e-4, rtol=1e-5)


def _jax_xla_linearize(xs, us):
    F = discretize(lambda xx, uu: _jax_quad(xx, uu, None), DT, 1)
    return jax.vmap(lambda a, b: linearize(F, a, b))(xs, us)


def test_vde_quad_matches_jax():
    """The draw and tolerance of ``tests/test_pallas_vde.py:124-141``; the
    port takes params of shape (B, 0), the Pallas kernel one padded row."""
    B, N = 4, 5
    xs, us = quad_traj(np.random.default_rng(13), B, N)
    lin = make_vde(tq.QuadDynamics(), DT, N, 13, 4, 0, device="cpu")
    got = lin(torch.as_tensor(xs), torch.as_tensor(us), torch.zeros((B, 0)))
    assert lin.launches == 0 and got[0].shape == (B, N, 13, 13)
    pallas = jax_make_vde(_jax_quad, DT, N, 13, 4, 0, block_b=8, interpret=True)
    refs = (pallas(jnp.asarray(xs), jnp.asarray(us), jnp.zeros((B, 1))),
            _jax_xla_linearize(jnp.asarray(xs), jnp.asarray(us)))
    for ref in refs:
        for g, w in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5)


def test_rk4_quad_without_params_matches_jax():
    """Both modes of the tangent-free map with ``p_dim=0``: the defect is
    the sweep's c, the step takes u as a strided view."""
    B, N = 5, 6
    xs, us = quad_traj(np.random.default_rng(21), B, N)
    rk4 = make_rk4(tq.QuadDynamics(), DT, 13, 4, 0, device="cpu")
    p = torch.zeros((B, 0))
    defect = rk4.defect(torch.as_tensor(xs), torch.as_tensor(us), p)
    step = rk4(torch.as_tensor(xs[:, 0]), torch.as_tensor(us)[:, 2], p)
    assert rk4.launches == 0 and defect.shape == (B, N, 13)
    F = discretize(lambda xx, uu: _jax_quad(xx, uu, None), DT, 1)
    c = jax.vmap(jax.vmap(F))(jnp.asarray(xs[:, :-1]), jnp.asarray(us)) - xs[:, 1:]
    np.testing.assert_allclose(defect.numpy(), np.asarray(c), atol=1e-5)
    want = jax.vmap(F)(jnp.asarray(xs[:, 0]), jnp.asarray(us[:, 2]))
    np.testing.assert_allclose(step.numpy(), np.asarray(want), atol=1e-5)


def test_lq_13x4_matches_jax_unrolled_kernel():
    """The QP at the quad's shape (N=10, 18 iterations, hard [0, 1] input
    box: 8 cones) against ``_lq_kernel``, the stage-unrolled Pallas kernel
    that ``make_lq_solver`` takes for N < 16 (interpret mode)."""
    B, N, nx, nu = 2, 10, 13, 4
    args = random_lq(np.random.default_rng(5), B, N, nx, nu)
    Q, R = QUAD_LQ_WEIGHTS
    ub, xb = BOUNDS["unit"](nx, nu)
    qp = make_lq_solver(N, nx, nu, Q, R, 10 * Q, ub, xb, iters=18, device="cpu")
    assert qp._bounds.n == 8
    dx, du, alpha = qp(*(torch.as_tensor(a) for a in args))
    assert qp.launches == 0 and bool(((alpha >= 0) & (alpha <= 1)).all())
    ref = jax_make_lq_solver(N, nx, nu, Q, R, 10 * Q, ub, xb, iters=18,
                             interpret=True, block_b=8, roll_stages=False)(*args)
    np.testing.assert_allclose(du.numpy(), np.asarray(ref[1]), atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref[0]), atol=3e-4, rtol=1e-3)


def test_lq_geometry_13x4_matches_the_kernel_layout():
    """c5's QP (N=10, 8 cones) in the layout of ``csrc/lq_ipm_wide.cuh``: a
    team of 16 lanes (one per 4x4 tile of the 16x16 products), a header of
    768 floats (Q and QN padded to 16x16, R, the cone list, to 32), 3,152
    floats per scenario (16 mod 32: the 2 teams of a warp 16 banks apart),
    and 8 scenarios per block of 128 threads, 2 blocks and 16 scenarios
    resident on an SM within the H100's 233,472 bytes."""
    assert cuda_lq.team_lanes(13) == 16 and cuda_lq.team_lanes(7) == 8
    assert cuda_lq.header_floats(13, 4) == 768
    # lq_wide::Layout at N=10, 8 cones: the iterate and the step (rows of
    # 16), the gains [K | kf] (4x16 a stage), the cone variables and
    # references, q and r, the ring of 16 stages' weights and gradients, the
    # tiles (P, [PA | p], (P Bm)^T, [H_ux | Bm^T p], H_uu, q_k, wx_k, r_k)
    # and two stage buffers (A in rows of 16, Bm).
    nst = 16 * 11 + 4 * 10
    parts = (2 * nst + 10 * 64 + 4 * 8 * 10 + 8 * 10 + 184 + 2 * 16 * 8
             + (2 * 256 + 2 * 64 + 16 + 2 * 16 + 4) + 2 * (13 * 16 + 13 * 4))
    geo = lq_geometry(10, 13, 4, 8)
    assert geo.pitch == parts + (16 - parts) % 32 == 3152
    assert geo.pitch % 32 == 16
    assert (geo.teams, geo.threads) == (8, 128)
    assert geo.block_bytes == 4 * (768 + 8 * 3152) <= cuda_lq.SMEM_BLOCK_MAX
    assert cuda_lq.SMEM_SM // (geo.block_bytes + cuda_lq.SMEM_BLOCK_RESERVED) == 2
    # The 7x2 layout is unchanged: 2,312 floats at c2 (N=30, 6 cones).
    assert lq_geometry(30, 7, 2, 6).pitch == 2312
    with pytest.raises(ValueError):
        lq_geometry(10, 13, 4, 8, teams=9)


def test_lq_geometry_13x4_spreads_a_small_batch():
    """Given the batch, the 13x4 geometry models an SM's time as the
    scenarios dealt to it over the scenarios it holds at once: 2 per block
    up to B=264 (one block on each of 128 SMs at B=256), 8 per block from
    c5's B=1024 (128 blocks, not 57 of 18); the 7x2 geometry keeps its 8."""
    teams = lambda B: lq_geometry(10, 13, 4, 8, batch=B).teams
    assert [teams(B) for B in (1, 37, 256, 1024, 4096, 16384)] == [2, 2, 2, 8, 8, 8]
    assert lq_geometry(10, 13, 4, 8, batch=256).blocks(256) == 128
    assert lq_geometry(30, 7, 2, 6, batch=256).teams == 8
    assert lq_geometry(10, 13, 4, 8, teams=4, batch=16384).teams == 4


def test_lq_geometry_13x4_over_horizons():
    """The 13x4 layout at N=10..40 (the rolled twin's range) with the quad's
    8 cones: every horizon fits, in whole warps, the scenarios resident on
    an SM falling from 16 to 6 as the iterate and the gains grow with N;
    the first horizon whose one scenario overflows a block is refused by
    ``lq_geometry`` and by the wrapper before any launch."""
    resident = {}
    for N in range(10, 41):
        geo = lq_geometry(N, 13, 4, 8)
        assert geo.block_bytes <= cuda_lq.SMEM_BLOCK_MAX
        assert geo.threads % 32 == 0 and geo.pitch % 32 == 16
        blocks = cuda_lq.SMEM_SM // (geo.block_bytes + cuda_lq.SMEM_BLOCK_RESERVED)
        resident[N] = geo.teams * blocks
    assert resident[10] == 16 and resident[40] == 6
    assert all(resident[N + 1] <= resident[N] for N in range(10, 40))
    fits = lambda N: 4 * (cuda_lq.header_floats(13, 4) + cuda_lq.scenario_floats(
        N, 13, 4, 8)) <= cuda_lq.SMEM_BLOCK_MAX
    n_max = max(N for N in range(10, 1000) if fits(N))
    assert n_max > 40 and not fits(n_max + 1)
    assert lq_geometry(n_max, 13, 4, 8).teams == 1
    with pytest.raises(ValueError):
        lq_geometry(n_max + 1, 13, 4, 8)
    Q, R = QUAD_LQ_WEIGHTS
    qp = make_lq_solver(n_max + 1, 13, 4, Q, R, 10 * Q, *BOUNDS["unit"](13, 4),
                        iters=1, device="cpu")
    args = [torch.as_tensor(a) for a in
            random_lq(np.random.default_rng(0), 1, n_max + 1, 13, 4)]
    with pytest.raises(ValueError):
        qp._launch(*args)
    assert qp.launches == 0


def test_lq_refuses_shapes_it_has_no_kernel_for():
    Q, R = np.eye(3), np.eye(1)
    qp = make_lq_solver(4, 3, 1, Q, R, Q, *BOUNDS["unit"](3, 1), iters=2,
                        device="cpu")
    args = [torch.as_tensor(a) for a in random_lq(np.random.default_rng(0), 2, 4, 3, 1)]
    with pytest.raises(NotImplementedError):
        qp._launch(*args)


@pytest.mark.parametrize("seed", [0, 3])
def test_quad_scenarios_and_circle_reference_match_jax(seed):
    B, N = 16, 10
    r, s, a = quad_fleet.make_quad_scenarios(B, seed)
    for got, want in zip((r, s, a), jax_quad_fleet.make_quad_scenarios(B, seed)):
        np.testing.assert_array_equal(got, np.asarray(want))
    theta = np.linspace(0.0, 6.0, B).astype(np.float32)
    om = s / r
    ref = quad_fleet.circle_reference(*(torch.as_tensor(v) for v in (theta, r, om, a)),
                                      N, DT)
    want = jax.vmap(lambda th, rr, o, al: jax_quad_fleet.circle_reference(
        th, rr, o, al, N, DT))(theta, r, om, a)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


@pytest.fixture(scope="module")
def three_ticks():
    """Three c5 ticks at B=8 in both packages (two Gauss-Newton iterations,
    the JAX package's XLA backend), with the carries after each."""
    B = 8
    tick_j, init_j, _, _ = jax_quad_fleet.build_quad_fleet(backend="xla",
                                                           sqp_iters=2)
    tick, init, solver, _ = quad_fleet.build_quad_fleet(device="cpu")
    # The JAX tick donates its carry: keep numpy copies.
    snap = lambda c: jax.tree.map(np.asarray, c)
    carry_j, carry = init_j(B), init(B)
    inits = (snap(carry_j), carry)
    ticks = []
    for _ in range(3):
        carry_j, aux_j = tick_j(carry_j)
        carry, aux = tick(carry)
        ticks.append((snap(carry_j), snap(aux_j), carry, aux))
    return inits, ticks, solver


def test_quad_fleet_ticks_match_jax(three_ticks):
    """States, lat and kkt at ``tests/test_torch_solver.py:75-93``'s
    tolerances; the plain backend launches nothing."""
    (carry_j, carry), ticks, solver = three_ticks
    for a, b in zip(carry_j[:5], carry[:5]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(carry_j[5].us, carry[5].us.numpy())
    for carry_j, (kkt_j, lat_j), carry, (kkt, lat) in ticks:
        np.testing.assert_allclose(carry[0].numpy(), np.asarray(carry_j[0]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(lat), float(lat_j), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(kkt.numpy(), np.asarray(kkt_j), rtol=1e-2,
                                   atol=1e-7)
    assert solver.vde.launches == solver.qp.launches == solver.rk4.launches == 0


def test_second_gauss_newton_iteration_relinearizes():
    """With ``sqp_iters=2`` the sweep runs at the first iteration's updated
    iterate, and the solve agrees with the JAX package's."""
    B, N = 3, 5
    spec_j = jax_quad_spec(n_nodes=N, t_horizon=0.5, qp_iters=8, sqp_iters=2)
    xs, us = quad_traj(np.random.default_rng(2), B, N)
    x0 = xs[:, 0]
    yref = np.repeat(x0[:, None], N + 1, axis=1)
    yref[:, :, 2] += 0.5
    yref_u = np.full((B, N, 4), 0.1226, np.float32)
    p = np.zeros((B, 0), np.float32)
    ref = JaxBatchedSQPSolver(spec_j, lambda x, u: jq.quad_dynamics_lane(x, u, None),
                              p_dim=0, backend="xla").solve(
        *(jnp.asarray(a) for a in (x0, yref, yref_u, p)),
        JaxSolverState(jnp.asarray(xs), jnp.asarray(us)))
    solver = BatchedSQPSolver(convert.quad_spec(spec_j), tq.QuadDynamics(),
                              p_dim=0, device="cpu")
    points = []
    plain = solver.vde.plain
    solver.vde.plain = lambda xs_, us_, ps_: (points.append(xs_), plain(xs_, us_, ps_))[1]
    res = solver.solve(*(torch.as_tensor(a) for a in (x0, yref, yref_u, p)),
                       SolverState(torch.as_tensor(xs), torch.as_tensor(us)))
    assert len(points) == 2 and not torch.equal(points[0], points[1])
    np.testing.assert_allclose(res.us.numpy(), np.asarray(ref.us), atol=1e-4)
    np.testing.assert_allclose(res.xs.numpy(), np.asarray(ref.xs), atol=1e-4,
                               rtol=1e-4)


def test_quad_functor_params():
    """The quad names its C entries and states its shape, and the struct it
    passes by value has the fields of ``QuadParamsC`` in
    ``csrc/vde_models.cuh``, in that order, holding the lane form's
    scalars."""
    csrc = Path(__file__).resolve().parents[1] / "ad_mpc_tpu_torch" / "csrc"
    src = "\n".join(p.read_text() for p in sorted(csrc.glob("vde*")))
    assert re.search(r"\bVDE_TEAM_ENTRIES\(quad, QuadDyn, QuadParamsC\)", src)
    body = re.sub(r"//[^\n]*", "",
                  re.search(r"struct QuadParamsC \{(.*?)\};", src, re.S).group(1))
    names = [n.strip().split("[")[0] for line in body.split(";") if line.strip()
             for n in line.replace("float", "").split(",")]
    f = tq.QuadDynamics()
    assert (f.nx, f.nu, f.p_dim) == (13, 4, 0)
    assert (f.cuda_entry, f.cuda_rk4_entry) == ("vde_quad", "rk4_quad")
    params = f.cuda_params()
    assert [n for n, _ in params._fields_] == names
    np.testing.assert_allclose(
        [params.max_thrust, params.mass, params.g, params.jyy_jzz, *params.y_f],
        [20.0, 1.0, 9.81, -0.03, *_QP.y_f], rtol=1e-7)


def test_cuda_refuses_a_functor_of_another_shape():
    """A sweep whose (nx, nu) is not its functor's is refused before any
    card is needed."""
    with pytest.raises(ValueError):
        make_vde(tq.QuadDynamics(), DT, 4, 7, 2, 0, device="cuda")
    with pytest.raises(ValueError):
        make_rk4(tq.QuadDynamics(), DT, 13, 2, 0, device="cuda")


def test_quad_params_and_spec_convert():
    assert convert.quadrotor_params(_QP) == tq.QuadrotorParams()
    spec = convert.quad_spec(jax_quad_spec())
    assert (spec.nx, spec.nu, spec.n_nodes, spec.qp_iters) == (13, 4, 10, 18)
    Q, R, QN = spec.weight_arrays()
    np.testing.assert_allclose(np.diag(QN)[:3], 10.0)
    with pytest.raises(ValueError):
        convert.quad_spec(jax_bicycle_spec())


def test_c5_roofline_counts_the_deployed_iterations():
    """The port's roofline gives c5 its two Gauss-Newton iterations (the
    reference's ``bench.py:559`` passes one)."""
    assert bench.solve_dims("c5_quad_b256") == (10, 13, 4, 18, 2)
    detail = {"configs": {"c5_quad_b256": {"solves_per_s": 1.0}}}
    bench.annotate_roofline(detail)
    one = bench.analytic_flops_per_solve(10, 13, 4, 18, 1, 150)
    two = detail["configs"]["c5_quad_b256"]["flops_per_solve"]
    assert two == bench.analytic_flops_per_solve(10, 13, 4, 18, 2, 150) > one
    failures = bench.gate_failures({"configs": {"c5_quad_b4": {
        "kkt_mean": 1e-7, "kkt_max": 2e-4, "lat_err_mean_m": 0.001}},
        "c5_rti_vs_converged_u0": 2e-3, "errors": {}})
    assert len(failures) == 2
