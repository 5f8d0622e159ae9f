"""Port parity for the c4 path: the Pacejka model, its VDE sweep and RK4
map, the friction-circle speed cap, the fleet's scenario draws and three
closed-loop ticks.

Every input is drawn from a seed with numpy and handed to both packages;
the JAX side runs on the CPU on its XLA path.

Tolerances. The JAX package evaluates atan by ``atan_mosaic``, whose
stated error is < 4e-7 in value and first derivative; the port uses
``torch.atan``. Both enter the lateral forces multiplied by
mu F_z D C (up to 1.1 x 8,829 N x 1.15 x 1.9 = 2.1e4 N at the front
axle), once as the outer atan and once through the slip angle times B
(up to 12 x 1.2 = 14.4): at most 2.1e4 x (1 + 14.4) x 4e-7 = 0.13 N of
force, 0.13 / 1,500 kg = 8.7e-5 m/s^2 in v_x_dot and v_y_dot and
(1.08 + 1.62) x 0.13 / 2,625 = 1.3e-4 rad/s^2 in psi_ddot. That is the
bound ``F_TOL`` of the dynamics. One RK4 step of dt = 0.05 s carries at
most dt x that into the state (6.5e-6), inside the VDE's 2e-5
(``tests/test_pallas_vde.py``); the sweep's sensitivities are held at the
same 2e-5, and the fleet's states and u0 at the tolerances of
``test_torch_solver.py:test_fleet_ticks_match_bench`` and 1e-3.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from ad_mpc_tpu.models import pacejka as jp
from ad_mpc_tpu.ops.integrators import discretize, linearize
from ad_mpc_tpu.utils.math import atan_mosaic
from ad_mpc_tpu_torch import bench, convert, fleet
from ad_mpc_tpu_torch.models import pacejka as tp
from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4, make_vde
from ad_mpc_tpu_torch.testing import pacejka_inputs, random_traj
from ad_mpc_tpu_torch.testing import one_thread  # noqa: F401 (autouse)


DT = 0.05
F_TOL = 1.3e-4  # the atan bound carried through the tire forces (above)
_PP = jp.PacejkaParams()


def _jax_pacejka(x, u, p):
    return jp.pacejka_dynamics_p(x, u, p, _PP)


def _draw_p(rng, n, entries=5):
    """p as the c4 sweep draws it (``fleet.make_pacejka``'s ``p_of``)."""
    _, p_of, _ = fleet.make_pacejka()
    p = np.stack([p_of(0.0, 0.0, rng.uniform(0.0, 1.0, 8)) for _ in range(n)])
    return p[:, :entries]


@pytest.mark.parametrize("lo,hi", [(-1.5, 1.5), (-100.0, 100.0), (-1e-4, 1e-4)])
def test_atan_matches_atan_mosaic(lo, hi):
    """The value over ``tests/test_math.py``'s ranges, within the 4e-7
    that ``atan_mosaic`` states."""
    x = np.linspace(lo, hi, 200_001).astype(np.float32)
    got = torch.atan(torch.as_tensor(x)).numpy()
    want = np.asarray(jax.jit(atan_mosaic)(x))
    assert np.abs(got - want).max() < 4e-7


def test_atan_derivative_matches_atan_mosaic():
    x = np.linspace(-5.0, 5.0, 50_001).astype(np.float32)
    xt = torch.as_tensor(x).requires_grad_()
    (g,) = torch.autograd.grad(torch.atan(xt).sum(), xt)
    want = np.asarray(jax.vmap(jax.grad(atan_mosaic))(x))
    assert np.abs(g.numpy() - want).max() < 4e-7


@pytest.mark.parametrize("entries", [3, 5])
def test_pacejka_dynamics_match_jax(entries):
    rng = np.random.default_rng(0)
    n = 64
    xs, us = random_traj(rng, n, 1, 7, 2)
    x, u = xs[:, 0], us[:, 0]
    p = _draw_p(rng, n, entries)
    dyn = lambda xx, uu, pp: tp.pacejka_dynamics_p(xx, uu, pp)
    got = dyn(*(torch.as_tensor(a.T) for a in (x, u, p))).numpy().T
    want = jax.vmap(_jax_pacejka)(x, u, p)
    np.testing.assert_allclose(got, np.asarray(want), atol=F_TOL, rtol=0)
    # The defaults and the 3-entry p at unit scales are the 5-entry model.
    if entries == 5:
        p3 = np.concatenate([p[:, :3], np.ones((n, 2), np.float32)], axis=1)
        a = dyn(*(torch.as_tensor(v.T) for v in (x, u, p3)))
        b = dyn(*(torch.as_tensor(v.T) for v in (x, u, p3[:, :3])))
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def _xla_linearize(xs, us, ps):
    F = lambda p: discretize(lambda xx, uu: _jax_pacejka(xx, uu, p), DT, 1)
    return jax.vmap(lambda a, b, p: linearize(F(p), a, b))(xs, us, ps)


def test_vde_pacejka_matches_jax():
    B, N = 6, 5
    rng = np.random.default_rng(3)
    xs, us = random_traj(rng, B, N, 7, 2)
    ps = _draw_p(rng, B)
    lin = make_vde(tp.PacejkaDynamics(), DT, N, 7, 2, 5, device="cpu")
    got = lin(*(torch.as_tensor(a) for a in (xs, us, ps)))
    assert lin.launches == 0 and got[0].shape == (B, N, 7, 7)
    want = _xla_linearize(*(jnp.asarray(a) for a in (xs, us, ps)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0)


def test_rk4_pacejka_matches_jax():
    """Both modes of the tangent-free map: the defect is the sweep's c, the
    step takes u as a strided view."""
    B, N = 5, 6
    rng = np.random.default_rng(21)
    xs, us = random_traj(rng, B, N, 7, 2)
    ps = _draw_p(rng, B)
    rk4 = make_rk4(tp.PacejkaDynamics(), DT, 7, 2, 5, device="cpu")
    defect = rk4.defect(*(torch.as_tensor(a) for a in (xs, us, ps)))
    step = rk4(torch.as_tensor(xs[:, 0]), torch.as_tensor(us)[:, 2],
               torch.as_tensor(ps))
    assert rk4.launches == 0 and defect.shape == (B, N, 7)
    F = jax.vmap(lambda x, u, p: discretize(
        lambda xx, uu: _jax_pacejka(xx, uu, p), DT, 1)(x, u))
    c = jax.vmap(lambda x, u, p: F(x, u, jnp.broadcast_to(p, (N, 5))))(
        xs[:, :-1], us, ps) - xs[:, 1:]
    np.testing.assert_allclose(defect.numpy(), np.asarray(c), atol=2e-5, rtol=0)
    want = F(xs[:, 0], us[:, 2], ps)
    np.testing.assert_allclose(step.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_velocity_cap_matches_bench():
    """``make_pacejka``'s draw and cap are the bench's, and after the cap no
    scenario demands more than 75% of its drawn tire limit mu g D
    (``tests/test_pacejka.py:87-115``)."""
    _, p_of, v_cap = fleet.make_pacejka()
    _, p_of_j, v_cap_j = jax_bench.make_pacejka()
    rng = np.random.default_rng(3)
    n = 512
    v = rng.uniform(5.0, 15.0, n).astype(np.float32)
    kappa = (rng.uniform(-1.0, 1.0, n) * 0.05).astype(np.float32)
    extras = rng.uniform(0.0, 1.0, (n, 8))
    p = np.stack([p_of(0.0, 0.0, e) for e in extras])
    np.testing.assert_array_equal(p, np.stack([p_of_j(0.0, 0.0, e) for e in extras]))
    v_c = v_cap(v, kappa, p)
    np.testing.assert_array_equal(v_c, v_cap_j(v, kappa, p))
    assert (v_c <= v + 1e-6).all()
    limit = p[:, 0] * 9.81 * p[:, 4]
    assert (v_c**2 * np.abs(kappa) <= 0.75 * limit + 1e-4).all()
    feasible = v**2 * np.abs(kappa) <= 0.75 * limit
    np.testing.assert_allclose(v_c[feasible], v[feasible])


def test_fleet_init_matches_bench():
    """``build_fleet(v_cap=)``'s carry is the bench's, in its order of draws
    (``tests/test_pacejka.py:118-131``): the speed cap reaches both the
    reference speed and the initial forward velocity."""
    dyn, p_of, v_cap = fleet.make_pacejka()
    _, init, _, _ = fleet.build_fleet(dyn, p_of, v_cap=v_cap, n_nodes=4,
                                      device="cpu")
    dyn_j, p_of_j, v_cap_j = jax_bench.make_pacejka()
    _, init_j, _, _ = jax_bench.build_fleet(dyn_j, p_of_j, n_nodes=4,
                                            v_cap=v_cap_j)
    carry, carry_j = init(256), init_j(256)
    for a, b in zip(carry_j[:5], carry[:5]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    x0, _, v, kappa, p, _ = (c.numpy() if torch.is_tensor(c) else c
                             for c in carry)
    assert (v**2 * np.abs(kappa) <= 0.75 * p[:, 0] * 9.81 * p[:, 4] + 1e-3).all()
    np.testing.assert_array_equal(x0[:, 3], v)


def test_kernel_check_inputs_draw_the_fleet_p():
    """The kernels' check inputs (``testing.pacejka_inputs``, the smoke's
    and the gpu tests') carry the p that ``build_fleet``'s ``init`` draws
    for the same scenarios."""
    dyn, p_of, _ = fleet.make_pacejka()
    _, init, _, _ = fleet.build_fleet(dyn, p_of, n_nodes=4, device="cpu")
    _, (xs, us, ps) = pacejka_inputs(64, 4, "cpu")
    assert xs.shape == (64, 5, 7) and us.shape == (64, 4, 2)
    torch.testing.assert_close(ps, init(64)[4], rtol=0, atol=0)


def test_c4_ticks_match_bench():
    """Three ticks of the c4 fleet at B=8, N=10, against the bench's on
    its XLA path: states, lat and kkt at the tolerances of
    ``test_fleet_ticks_match_bench``, u0 within 1e-3."""
    B, N = 8, 10
    dyn, p_of, v_cap = fleet.make_pacejka()
    tick, init, solver, _ = fleet.build_fleet(dyn, p_of, n_nodes=N,
                                              v_cap=v_cap, device="cpu")
    dyn_j, p_of_j, v_cap_j = jax_bench.make_pacejka()
    tick_j, init_j, _, _ = jax_bench.build_fleet(dyn_j, p_of_j, n_nodes=N,
                                                 v_cap=v_cap_j, backend="xla")
    carry_j, carry = init_j(B), init(B)
    for _ in range(3):
        carry_j, (kkt_j, lat_j) = tick_j(carry_j)
        carry, (kkt, lat) = tick(carry)
        np.testing.assert_allclose(carry[0].numpy(), np.asarray(carry_j[0]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(carry[5].us[:, 0].numpy(),
                                   np.asarray(carry_j[5].us[:, 0]), atol=1e-3)
        np.testing.assert_allclose(float(lat), float(lat_j), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(kkt.numpy(), np.asarray(kkt_j), rtol=1e-2,
                                   atol=1e-7)
    assert solver.vde.launches == solver.qp.launches == solver.rk4.launches == 0


def test_pacejka_functor_params():
    """The Pacejka names its functor and C entries (a team functor's) and
    states its shape, and the struct it passes by value has the fields of
    ``PacejkaParamsC`` in ``csrc/vde_bicycle.cu``, in that order."""
    csrc = Path(__file__).resolve().parents[1] / "ad_mpc_tpu_torch" / "csrc"
    src = "\n".join(p.read_text() for p in sorted(csrc.glob("vde*")))
    assert re.search(r"\bVDE_TEAM_ENTRIES\(pacejka, PacejkaDyn, PacejkaParamsC\)", src)
    assert tp.PacejkaDynamics.cuda_team
    assert re.search(r"struct PacejkaDyn \{\s*static constexpr int NX = 7, NU = 2, "
                     r"NP = 5;", src)
    fields = re.search(r"struct PacejkaParamsC \{.*?float ([^;]+);", src, re.S)
    names = [n.strip() for n in fields.group(1).split(",")]
    f = tp.PacejkaDynamics()
    assert (f.nx, f.nu, f.p_dim) == (7, 2, 5)
    assert (f.cuda_functor, f.cuda_entry, f.cuda_rk4_entry) == (
        "PacejkaDyn", "vde_pacejka", "rk4_pacejka")
    params = f.cuda_params()
    assert [n for n, _ in params._fields_] == names
    want = [getattr(_PP, n) for n in names[:-1]] + [_PP.l_f + _PP.l_r]
    np.testing.assert_allclose([getattr(params, n) for n in names], want,
                               rtol=1e-7)


def test_pacejka_params_convert():
    assert convert.pacejka_params(_PP) == tp.PacejkaParams()
    assert convert.pacejka_params(_PP._replace(mu=0.7)).mu == 0.7


def test_c3_c4_rows_have_gates_and_flops():
    """The bench's c3 and c4 rows take their configs' gates
    (``bench.py:473-497``) and dynamics counts (``bench.py:522-528``)."""
    assert bench.GATES["c4_"] == {"kkt_mean": 8e-6, "kkt_max": 1e-4,
                                  "lat_err_mean_m": 0.15}
    assert bench.GATES["c3_"] == bench.GATES["c2_"]
    assert bench.RTI_GATES["c4_rti_vs_converged_u0"] == 7e-4
    assert (bench.DYN_FLOPS["c3_"], bench.DYN_FLOPS["c4_"]) == (1100, 170)
    detail = {"configs": {"c4_pacejka_b4096": {
        "kkt_mean": 1e-6, "kkt_max": 2e-4, "lat_err_mean_m": 0.1,
        "solves_per_s": 1.0}}, "c4_rti_vs_converged_u0": 8e-4, "errors": {}}
    assert len(bench.gate_failures(detail)) == 2
    bench.annotate_roofline(detail)
    assert detail["configs"]["c4_pacejka_b4096"]["flops_per_solve"] == (
        bench.analytic_flops_per_solve(30, 7, 2, 12, 1, 170))
