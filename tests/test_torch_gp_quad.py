"""Port parity for the c6 path: the synthetic and the fitted GP-quad
ensembles, the body-frame features and residual in matrix and lane form,
the GP-quad's VDE sweep and RK4 map, the functor's table, three
closed-loop ticks of the c6 fleet, its RTI gate and its bench rows.

Every input is drawn from a seed with numpy and handed to both packages;
the JAX side runs on the CPU on its XLA path. Tolerances: 1e-6 for the
residual (``tests/test_pallas_vde.py:208``), 1e-5 for the rotation property
(``tests/test_quad_fleet_gp.py:75``), 3e-5 for the sweep and the RK4 map
(``tests/test_pallas_vde.py:249-251``), the c5 ticks' tolerances of
``tests/test_torch_quad.py`` and 1e-3 for u0.

The fitted model (60 points) is compared in float64. Its means are sums of
terms up to 2,755 that cancel to under 6, so float32 rounding alone moves a
mean by about 1.5e-3 and one step's state by about 1e-4 (the port's and the
JAX package's float32 sweeps differ by 9e-5, each 2-3e-4 from float64):
3e-5 holds only between evaluations in float64, where both packages agree
to 1e-9.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ad_mpc_tpu.experiments import quad_fleet as jqf
from ad_mpc_tpu.learned import ensemble as je
from ad_mpc_tpu.learned import lane as jl
from ad_mpc_tpu.models.quadrotor import quad_dynamics_lane as jax_quad_lane
from ad_mpc_tpu.ops.integrators import discretize, linearize
from ad_mpc_tpu.utils.io import load_model
from ad_mpc_tpu.utils.math import v_dot_q as jax_v_dot_q
from ad_mpc_tpu_torch import bench, convert
from ad_mpc_tpu_torch.experiments import quad_fleet
from ad_mpc_tpu_torch.learned import ensemble as te
from ad_mpc_tpu_torch.learned import lane as tl
from ad_mpc_tpu_torch.models import gp_quad as tgq
from ad_mpc_tpu_torch.ops import _build
from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4, make_vde
from ad_mpc_tpu_torch.testing import quad_traj
from ad_mpc_tpu_torch.testing import one_thread  # noqa: F401 (autouse)
from ad_mpc_tpu_torch.utils.math import v_dot_q


DT = 0.1
REPO = Path(__file__).resolve().parents[1]


def _jax_dyn(ens_j):
    """The JAX package's c6 dynamics closure (``quad_fleet.py:116-118``)."""

    def f(x, u, p):
        base = jax_quad_lane(x, u, p)
        return jl.add_rows(base, jl.quad_lane_residual_terms(ens_j, x))

    return f


def _states(seed=2, n=6):
    """Unit quaternions and body velocities in the synthetic ensemble's
    [-5, 5]^3 range."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (n, 13))
    x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    x[:, 7:10] *= 2.0
    return x


@pytest.mark.parametrize("n", [32, 8])
def test_quad_gp_ensemble_matches_jax(n):
    got = quad_fleet.make_quad_gp_ensemble(n=n)
    want = jqf.make_quad_gp_ensemble(n=n)
    for name in te.GPEnsemble._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)))


def test_fitted_npz_is_the_committed_model():
    """``data/gp_flagship_c1.npz`` holds, bit for bit, what
    ``convert.gp_ensemble`` makes of the JAX package's pickled model, and
    ``learned.ensemble.load_npz`` reads it without JAX."""
    conv = convert.gp_ensemble(load_model("gp_flagship_c1"))
    with np.load(quad_fleet.FITTED_NPZ) as z:
        assert sorted(z.files) == sorted(te.GPEnsemble._fields)
        for name in te.GPEnsemble._fields:
            want = getattr(conv, name)
            if name in ("out_idx", "feat_idx"):
                assert tuple(int(i) for i in z[name]) == want
            else:
                assert z[name].dtype == want.dtype and z[name].shape == want.shape
                assert z[name].tobytes() == want.tobytes()
    loaded = quad_fleet.fitted_ensemble()
    assert loaded.x_train.shape == (3, 1, 60, 3) and loaded.out_idx == (7, 8, 9)
    probe = ("import sys; from ad_mpc_tpu_torch.experiments.quad_fleet import "
             "fitted_ensemble; e = fitted_ensemble(); "
             "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
             "'ad_mpc_tpu.')) or m == 'ad_mpc_tpu']; print(e.x_train.shape, bad); "
             "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_body_frame_residual_matches_jax():
    """``body_frame_features`` and ``quad_residual_fn`` (nearest centroid and
    a pinned cluster) at 1e-6, in float32."""
    ens_j = jqf.make_quad_gp_ensemble()
    ens = convert.gp_ensemble(ens_j)
    for xi in _states().astype(np.float32):
        xt = torch.as_tensor(xi)
        np.testing.assert_allclose(
            te.body_frame_features(xt, ens.feat_idx).numpy(),
            np.asarray(je.body_frame_features(jnp.asarray(xi), ens_j.feat_idx)),
            atol=1e-6)
        for cl in (None, np.zeros(3, np.int32)):
            np.testing.assert_allclose(
                te.quad_residual_fn(ens, cl)(xt, None).numpy(),
                np.asarray(je.quad_residual_fn(ens_j, cl)(jnp.asarray(xi), None)),
                atol=1e-6)


def test_residual_is_body_frame_rotated():
    """``tests/test_quad_fleet_gp.py:55-77`` on the port: yawing the body
    by 90 degrees with the same body-frame velocity rotates the world-frame
    residual with it."""
    ens = quad_fleet.make_quad_gp_ensemble()

    def resid_world(x):
        z = te.body_frame_features(x, ens.feat_idx)
        return v_dot_q(te.predict(ens, z), x[3:7])

    v_w = torch.tensor([2.0, -1.0, 0.5])
    x_id = torch.zeros(13)
    x_id[3], x_id[7:10] = 1.0, v_w
    q_yaw = torch.tensor([np.cos(np.pi / 4), 0.0, 0.0, np.sin(np.pi / 4)],
                         dtype=torch.float32)
    x_rot = torch.zeros(13)
    x_rot[3:7], x_rot[7:10] = q_yaw, v_dot_q(v_w, q_yaw)
    r_id, r_rot = resid_world(x_id), resid_world(x_rot)
    np.testing.assert_allclose(r_rot.numpy(), v_dot_q(r_id, q_yaw).numpy(),
                               atol=1e-5)
    # ... and the JAX package's residual at the same states.
    ens_j = jqf.make_quad_gp_ensemble()
    z_j = je.body_frame_features(jnp.asarray(x_rot.numpy()), ens_j.feat_idx)
    np.testing.assert_allclose(
        r_rot.numpy(),
        np.asarray(jax_v_dot_q(je.predict(ens_j, z_j), jnp.asarray(q_yaw.numpy()))),
        atol=1e-6)


def test_lane_residual_matches_jax_and_matrix_form():
    """``quad_lane_residual_terms`` on (13, 6) entries against the JAX lane
    form and against ``quad_residual_fn`` at 1e-6
    (``tests/test_pallas_vde.py:193-210``); it refuses another layout."""
    ens_j = jqf.make_quad_gp_ensemble(n=8)
    ens = convert.gp_ensemble(ens_j)
    x = _states().astype(np.float32)
    terms = tl.quad_lane_residual_terms(ens, torch.as_tensor(x.T))
    terms_j = jl.quad_lane_residual_terms(ens_j, jnp.asarray(x.T))
    assert sorted(terms) == sorted(terms_j) == [7, 8, 9]
    for r in terms:
        np.testing.assert_allclose(terms[r].numpy(), np.asarray(terms_j[r]),
                                   atol=1e-6)
    for i, xi in enumerate(x):
        old = te.quad_residual_fn(ens, np.zeros(3, np.int32))(
            torch.as_tensor(xi), None)
        np.testing.assert_allclose(old[7:10].numpy(),
                                   [float(terms[r][i]) for r in (7, 8, 9)],
                                   atol=1e-6)
        assert not old[:7].any() and not old[10:].any()
    with pytest.raises(ValueError):
        tl.quad_lane_residual_terms(ens._replace(out_idx=(7, 8, 10)),
                                    torch.as_tensor(x.T))


def _jax_linearize(f, xs, us, ps):
    F = lambda p: discretize(lambda xx, uu: f(xx, uu, p), DT, 1)
    return jax.jit(jax.vmap(lambda a, b, p: linearize(F(p), a, b)))(
        *(jnp.asarray(v) for v in (xs, us, ps)))


def _jax_matrix_dyn(ens_j):
    """The same dynamics with the residual in the JAX package's matrix
    form, ``quad_residual_fn`` at cluster 0 (held equal to the lane form by
    ``tests/test_pallas_vde.py:193-210``): vectorized over the points, so
    XLA compiles the 60-point model in seconds, not a minute."""
    resid = je.quad_residual_fn(ens_j, jnp.zeros(3, jnp.int32))
    return lambda x, u, p: jax_quad_lane(x, u, p) + resid(x, u)


@pytest.mark.parametrize("fitted", [False, True], ids=["n8", "fitted_n60"])
def test_vde_gp_quad_matches_jax(fitted):
    """The sweep against the JAX package's XLA linearization at 3e-5
    (``tests/test_pallas_vde.py:226-251``): in float32 on the 8-point
    synthetic ensemble (its lane form), in float64 on the fitted model
    (module docstring; its matrix form), where both agree to 1e-9."""
    ens_j = load_model("gp_flagship_c1") if fitted else jqf.make_quad_gp_ensemble(n=8)
    dtype, atol = (np.float64, 1e-9) if fitted else (np.float32, 3e-5)
    B, N = 4, 3
    xs, us = (a.astype(dtype) for a in quad_traj(np.random.default_rng(13), B, N))
    ps = np.zeros((B, 0), dtype)
    dyn = tgq.GPQuadDynamics(convert.gp_ensemble(ens_j))
    lin = make_vde(dyn, DT, N, 13, 4, 0, device="cpu")
    got = lin(*(torch.as_tensor(a) for a in (xs, us, ps)))
    assert lin.launches == 0 and got[0].dtype == torch.as_tensor(xs).dtype
    f_j = (_jax_matrix_dyn if fitted else _jax_dyn)(ens_j)
    want = _jax_linearize(f_j, xs, us, ps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)


def test_rk4_gp_quad_matches_jax():
    """Both modes of the tangent-free map (8-point ensemble) at 3e-5: the
    defect over every stage, the step with u a strided view."""
    ens_j = jqf.make_quad_gp_ensemble(n=8)
    f_j = _jax_dyn(ens_j)
    B, N = 5, 6
    xs, us = quad_traj(np.random.default_rng(21), B, N)
    rk4 = make_rk4(tgq.GPQuadDynamics(convert.gp_ensemble(ens_j)), DT, 13, 4, 0,
                   device="cpu")
    p = torch.zeros((B, 0))
    defect = rk4.defect(torch.as_tensor(xs), torch.as_tensor(us), p)
    step = rk4(torch.as_tensor(xs[:, 0]), torch.as_tensor(us)[:, 2], p)
    assert rk4.launches == 0
    F = discretize(lambda xx, uu: f_j(xx, uu, None), DT, 1)
    c = jax.vmap(jax.vmap(F))(jnp.asarray(xs[:, :-1]), jnp.asarray(us)) - xs[:, 1:]
    np.testing.assert_allclose(defect.numpy(), np.asarray(c), atol=3e-5, rtol=0)
    want = jax.vmap(F)(jnp.asarray(xs[:, 0]), jnp.asarray(us[:, 2]))
    np.testing.assert_allclose(step.numpy(), np.asarray(want), atol=3e-5, rtol=0)


@pytest.fixture(scope="module")
def c6_ticks():
    """Three c6 ticks at B=8 with the 8-point ensemble in both packages
    (two Gauss-Newton iterations, the JAX package's XLA backend), and three
    c5 ticks of the port from the same start."""
    B = 8
    ens_j = jqf.make_quad_gp_ensemble(n=8)
    ens = quad_fleet.make_quad_gp_ensemble(n=8)
    tick_j, init_j, _, _ = jqf.build_quad_fleet(backend="xla", ensemble=ens_j,
                                                sqp_iters=2)
    tick, init, solver, _ = quad_fleet.build_quad_fleet(device="cpu", ensemble=ens)
    tick_n, init_n, _, _ = quad_fleet.build_quad_fleet(device="cpu")
    snap = lambda c: jax.tree.map(np.asarray, c)  # the JAX tick donates its carry
    carry_j, carry, carry_n = init_j(B), init(B), init_n(B)
    ticks = []
    for _ in range(3):
        carry_j, aux_j = tick_j(carry_j)
        carry, aux = tick(carry)
        carry_n, _ = tick_n(carry_n)
        ticks.append((snap(carry_j), snap(aux_j), carry, aux))
    return ticks, carry_n, solver


def test_c6_ticks_match_jax(c6_ticks):
    ticks, carry_n, solver = c6_ticks
    for carry_j, (kkt_j, lat_j), carry, (kkt, lat) in ticks:
        np.testing.assert_allclose(carry[0].numpy(), np.asarray(carry_j[0]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(carry[5].us[:, 0].numpy(),
                                   np.asarray(carry_j[5].us[:, 0]), atol=1e-3)
        np.testing.assert_allclose(float(lat), float(lat_j), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(kkt.numpy(), np.asarray(kkt_j), rtol=1e-2,
                                   atol=1e-7)
    assert solver.vde.launches == solver.qp.launches == solver.rk4.launches == 0
    # The residual flows through the solve (``tests/test_quad_fleet_gp.py:48``).
    us = ticks[-1][2][5].us
    assert float((us - carry_n[5].us).abs().max()) > 1e-5


def test_gp_quad_functor_params():
    """The GP-quad names its functor and C entries, and its struct has the
    layout of ``GPQuadParamsC`` in ``csrc/vde_gp_quad.cu``: the quad's
    scalars, then n, then the table at the source's capacity (3,208 bytes)."""
    src = "\n".join(p.read_text() for p in sorted(
        (REPO / "ad_mpc_tpu_torch" / "csrc").glob("vde*")))
    assert re.search(r"\bVDE_TEAM_ENTRIES\(gp_quad, GPQuadDyn, GPQuadParamsC\)", src)
    cap = re.search(r"constexpr int GP_QUAD_POINTS = (\d+);(?s:.*)"
                    r"constexpr int GP_QUAD_DIMS = (\d+), GP_QUAD_FEATS = (\d+);",
                    "\n".join(p.read_text() for p in (
                        REPO / "ad_mpc_tpu_torch" / "csrc" / "vde_gp_quad.cu",
                        REPO / "ad_mpc_tpu_torch" / "csrc" / "vde_models.cuh")))
    assert tuple(int(v) for v in cap.groups()) == (
        tgq.GP_QUAD_POINTS, tgq.GP_QUAD_DIMS, tgq.GP_QUAD_FEATS)
    body = re.sub(r"//[^\n]*", "", re.search(
        r"struct GPQuadParamsC \{(.*?)\};", src, re.S).group(1))
    names = [line.split()[-1].split("[")[0] for line in body.split(";")
             if line.strip()]
    for ens in (quad_fleet.make_quad_gp_ensemble(), quad_fleet.fitted_ensemble()):
        f = tgq.GPQuadDynamics(ens)
        assert (f.nx, f.nu, f.p_dim) == (13, 4, 0)
        assert (f.cuda_functor, f.cuda_entry, f.cuda_rk4_entry) == (
            "GPQuadDyn", "vde_gp_quad", "rk4_gp_quad")
        params = f.cuda_params()
        assert [n for n, _ in params._fields_] == names
        assert ctypes.sizeof(params) == 3208 < 4096
        n = ens.x_train.shape[2]
        assert params.n == n and params.quad.max_thrust == 20.0
        X = np.ctypeslib.as_array(params.X)
        np.testing.assert_allclose(X[2, :n], ens.x_train[2, 0], rtol=1e-7)
        assert not X[:, n:].any()
        np.testing.assert_allclose(np.ctypeslib.as_array(params.a)[1, :n],
                                   ens.k_inv_y[1, 0] * ens.sigma_f[1, 0], rtol=1e-6)
        np.testing.assert_allclose(np.ctypeslib.as_array(params.inv_l)[0],
                                   1.0 / ens.len_scale[0, 0], rtol=1e-7)


def test_gp_quad_functor_refuses_what_it_cannot_hold():
    """More points than the table holds, another layout of features and
    outputs, or another number of dims or features is refused before any
    launch."""
    with pytest.raises(ValueError):
        tgq.GPQuadDynamics(quad_fleet.make_quad_gp_ensemble(n=65)).cuda_params()
    ens = quad_fleet.make_quad_gp_ensemble(n=8)
    others = (ens._replace(feat_idx=(7, 8, 10)), ens._replace(out_idx=(7, 8, 10)),
              ens._replace(x_train=ens.x_train[:, :, :, :2]),
              ens._replace(x_train=ens.x_train[:2]))
    for other in others:
        with pytest.raises(ValueError):
            tgq.GPQuadDynamics(other).cuda_params()
    with pytest.raises(ValueError):
        make_vde(tgq.GPQuadDynamics(others[0]), DT, 4, 13, 4, 0, device="cuda")


PTXAS = """\
ptxas info    : Compiling entry function '_Z10vde_kernelI7QuadDynEvPKfS2_S2_PfS3_S3_iii5StepsT_' for 'sm_90a'
    456 bytes stack frame, 456 bytes spill stores, 512 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers
ptxas info    : Compiling entry function '_Z10vde_kernelI9GPQuadDynEvPKfS2_S2_PfS3_S3_iii5StepsT_' for 'sm_90a'
    600 bytes stack frame, 640 bytes spill stores, 700 bytes spill loads
ptxas info    : Used 254 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z10rk4_kernelI9GPQuadDynEvPKfxS2_xxS2_xPfiiii5StepsT_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers"""


def test_functor_resources_keep_quad_and_gp_quad_apart(monkeypatch):
    """``QuadDyn`` is a suffix of ``GPQuadDyn``: the registers are found by
    the whole template argument, so each gets its own."""
    monkeypatch.setattr(_build, "ptxas_report", lambda name, defines=(): PTXAS)
    assert _build.functor_resources("vde", "vde_kernel", "QuadDyn") == {
        "registers": 255, "spill_stores": 456, "spill_loads": 512}
    assert _build.functor_resources("vde", "vde_kernel", "GPQuadDyn") == {
        "registers": 254, "spill_stores": 640, "spill_loads": 700}
    assert _build.functor_resources("vde", "rk4_kernel", "GPQuadDyn")[
        "registers"] == 72
    with pytest.raises(RuntimeError):
        _build.functor_resources("vde", "rk4_kernel", "QuadDyn")


def test_c6_bench_rows():
    """c6 rows get the tick's two Gauss-Newton iterations in the roofline
    (the reference's ``bench.py:559`` passes one), the fitted rows their
    own gates (``c6_fitted_`` matched before ``c6_``), and both RTI gates
    hold."""
    assert bench.solve_dims("c6_gp_quad_b256") == (10, 13, 4, 18, 2)
    assert bench.solve_dims("c6_fitted_gp_quad_b4096") == (10, 13, 4, 18, 2)
    prefixes = list(bench.GATES)
    assert prefixes.index("c6_fitted_") < prefixes.index("c6_")
    assert bench._gates_for("c6_fitted_gp_quad_b4096") == quad_fleet.FITTED_GATES
    assert bench._gates_for("c6_gp_quad_b16384") == quad_fleet.GATES
    detail = {"configs": {"c6_gp_quad_b256": {"solves_per_s": 1.0}}}
    bench.annotate_roofline(detail)
    assert detail["configs"]["c6_gp_quad_b256"]["flops_per_solve"] == (
        bench.analytic_flops_per_solve(10, 13, 4, 18, 2, 1450))
    row = {"kkt_mean": 5e-5, "kkt_max": 3e-4, "lat_err_mean_m": 0.001}
    failures = bench.gate_failures({"configs": {
        "c6_fitted_gp_quad_b4096": row, "c6_gp_quad_b4096": row},
        "c6_rti_vs_converged_u0": 2e-3, "errors": {}})
    assert len(failures) == 3 and all("fitted" not in f for f in failures)


def test_gp_quad_least_count_follows_the_kernels_design():
    """The sweep's least operations per stage (``chip_smoke``): the quad's
    own sweep plus, per RK4 evaluation, the float rotations, the GP's means
    and gradients, the residual's float Jacobian and its lift by one
    contraction; no rotation carried as duals. Far under what
    ``experiments.opcount`` counts for the plain lane form carried in
    forward mode, so the kernel's bound stays a least bound."""
    import chip_smoke
    from ad_mpc_tpu_torch.experiments.opcount import dyn_counts, sweep_flops
    from ad_mpc_tpu_torch.models.quadrotor import quad_dynamics_lane

    p = torch.zeros(0)
    quad = sweep_flops(dyn_counts(lambda x, u, p: quad_dynamics_lane(x, u),
                                  13, 4, p), 13, 4)
    assert quad == 12151 and chip_smoke.GP_QUAD_JACOBIAN_OPS == 265
    assert chip_smoke.gp_quad_vde_flops_per_stage(32) == (
        quad + 4 * (55 + 1065 + 585 + 265 + 3 * 17 * 14))
    plain = sweep_flops(dyn_counts(
        tgq.GPQuadDynamics(quad_fleet.make_quad_gp_ensemble()), 13, 4, p), 13, 4)
    assert chip_smoke.gp_quad_vde_flops_per_stage(32) < plain
    assert (chip_smoke.gp_quad_vde_flops_per_stage(60)
            - chip_smoke.gp_quad_vde_flops_per_stage(32)) == 4 * 28 * (
        sum(chip_smoke.gp_ops(1, 3, 3)) - sum(chip_smoke.gp_ops(0, 3, 3)))


@pytest.mark.parametrize("rows", [True, False], ids=["rows", "entries"])
def test_f64_anchored_holds_each_row_to_its_own_spread(rows):
    """``testing.f64_anchored``: an error within atol plus 4 times the
    float32 spread of its own row (or entry) passes; the same error where
    float32 is accurate fails, whatever the spread elsewhere in the
    tensor."""
    from ad_mpc_tpu_torch.testing import SPREAD_FACTOR, f64_anchored

    gen = torch.Generator().manual_seed(0)
    exact = torch.randn((5, 3, 4), generator=gen, dtype=torch.float64)
    spread = torch.full_like(exact, 1e-8)
    spread[:, 0] = 1e-3  # an ill-conditioned row beside well-conditioned ones
    runs = [exact + spread, exact - spread / 2]
    atol = 3e-5
    near = exact.float() + (atol + 2 * 1e-3) * (spread > 1e-4)
    err, s, ratio, ok = f64_anchored(near, runs, exact, atol, rows)
    assert ok and s == pytest.approx(1e-3) and 1.9 < ratio < SPREAD_FACTOR
    assert err == pytest.approx(atol + 2e-3, rel=1e-4)
    off = exact.float()
    off[2, 1, 3] += 1e-4  # 3x atol where float32 is accurate
    assert not f64_anchored(off, runs, exact, atol, rows)[3]
    assert not f64_anchored(near.clone().fill_(float("nan")), runs, exact,
                            atol, rows)[3]


def test_perturbed_moves_each_entry_by_about_one_ulp():
    from ad_mpc_tpu_torch.testing import perturbed

    args = (torch.linspace(1, 2, 64), torch.zeros((4, 0)))
    a, b = perturbed(args, 3)
    assert b.shape == (4, 0)
    rel = ((a - args[0]) / args[0]).abs()
    assert 0 < float(rel.max()) < 2.0**-23 * 6
    assert torch.equal(a, perturbed(args, 3)[0])
    assert not torch.equal(a, perturbed(args, 4)[0])


def test_table_perturbed_moves_the_gp_terms_by_about_one_ulp():
    """``testing.table_perturbed``: a copy of the GP quad whose training
    features and weights each move by about one float32 ulp, the rest of
    the model and the original left as they were."""
    from ad_mpc_tpu_torch.testing import table_perturbed

    dyn = tgq.GPQuadDynamics(quad_fleet.fitted_ensemble())
    ens = dyn.ensemble
    moved = table_perturbed(dyn, 1)
    assert type(moved) is type(dyn) and moved.params == dyn.params
    for name in ("x_train", "k_inv_y"):
        old = np.asarray(getattr(ens, name), np.float64)
        new = np.asarray(getattr(moved.ensemble, name))
        rel = np.abs(new - old)[old != 0] / np.abs(old[old != 0])
        assert 0 < rel.max() < 2.0**-23 * 6
    for name in ("len_scale", "sigma_f", "y_mean", "out_idx", "feat_idx"):
        np.testing.assert_array_equal(np.asarray(getattr(moved.ensemble, name)),
                                      np.asarray(getattr(ens, name)))
    assert not np.array_equal(np.asarray(table_perturbed(dyn, 2).ensemble.k_inv_y),
                              np.asarray(moved.ensemble.k_inv_y))
    assert np.array_equal(np.asarray(table_perturbed(dyn, 1).ensemble.k_inv_y),
                          np.asarray(moved.ensemble.k_inv_y))
