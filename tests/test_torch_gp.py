"""Port parity for the c3 path: the GP kernel and mean, the stacked
ensemble, the baked lane mean, the GP-bicycle's VDE sweep and RK4 map,
the functor's table, and three closed-loop ticks of the c3 fleet.

Every input is drawn from a seed with numpy and handed to both packages;
the JAX side runs on the CPU on its XLA path. Tolerances: 1e-6 for the GP
mean (``tests/test_pallas_vde.py:210``), 2e-5 for the sweep and the RK4
map (``tests/test_pallas_vde.py:222-224``), the tolerances of
``test_torch_solver.py:test_fleet_ticks_match_bench`` and 1e-3 for u0.
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from ad_mpc_tpu.learned import ensemble as je
from ad_mpc_tpu.learned import gp as jgp
from ad_mpc_tpu.learned import lane as jl
from ad_mpc_tpu.models.bicycle import BicycleParams, bicycle_dynamics
from ad_mpc_tpu.ops.integrators import discretize, linearize
from ad_mpc_tpu_torch import convert, fleet
from ad_mpc_tpu_torch.learned import ensemble as te
from ad_mpc_tpu_torch.learned import gp as tgp
from ad_mpc_tpu_torch.learned import lane as tl
from ad_mpc_tpu_torch.models import gp_bicycle as tgb
from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4, make_vde
from ad_mpc_tpu_torch.testing import random_traj
from ad_mpc_tpu_torch.testing import one_thread  # noqa: F401 (autouse)


DT = 0.05
_BP = BicycleParams()


def _gps(params_cls, n_per_cluster=(9, 6), d=4, D=2, seed=5):
    """Per-dim lists of per-cluster GPs with unequal training sets (so that
    the ensemble pads) and clusters out of centroid order (so that it
    sorts)."""
    rng = np.random.default_rng(seed)
    gps = []
    for _ in range(D):
        row = []
        for c, n in enumerate(n_per_cluster):
            X = rng.uniform(-1.0, 1.0, (n, d)) + 2.0 * (len(n_per_cluster) - c)
            row.append(params_cls(
                X, rng.normal(0.0, 1.0, n), rng.uniform(0.3, 2.0, d),
                0.4, 0.05, float(rng.normal()), X.mean(axis=0)))
        gps.append(row)
    return gps


def _ensembles():
    out, feat = (1, 3), (0, 1, 2, 4)
    ens_j = je.GPEnsemble.from_gps(_gps(jgp.GPParams), out, feat)
    ens_t = te.GPEnsemble.from_gps(_gps(tgp.GPParams), out, feat)
    return ens_j, ens_t


def test_ensemble_and_convert_match_jax():
    """``from_gps`` pads and sorts as the JAX package does, and
    ``convert.gp_ensemble`` carries the JAX ensemble across unchanged."""
    ens_j, ens_t = _ensembles()
    conv = convert.gp_ensemble(ens_j)
    for name in te.GPEnsemble._fields:
        for got in (getattr(ens_t, name), getattr(conv, name)):
            np.testing.assert_array_equal(np.asarray(got),
                                          np.asarray(getattr(ens_j, name)))
    assert conv.out_idx == (1, 3) and conv.feat_idx == (0, 1, 2, 4)
    assert ens_t.n_valid.tolist() == [[6, 9], [6, 9]]  # sorted by centroid
    assert not ens_t.k_inv_y[:, 0, 6:].any()  # padding carries a = 0


def test_gp_kernel_and_mean_match_jax():
    g = _gps(tgp.GPParams)[0][0]
    rng = np.random.default_rng(1)
    z = rng.normal(0.0, 1.0, (8, 4))
    X = np.asarray(g.x_train)
    np.testing.assert_allclose(
        tgp.kernel(torch.as_tensor(z), torch.as_tensor(X),
                   torch.as_tensor(g.len_scale), g.sigma_f).numpy(),
        np.asarray(jgp.kernel(z, X, g.len_scale, g.sigma_f)), rtol=1e-12)
    jg = jgp.GPParams(*(jnp.asarray(v) if isinstance(v, np.ndarray) else v
                        for v in g))
    for zi in z:
        np.testing.assert_allclose(
            float(tgp.predict_mean(g, torch.as_tensor(zi))),
            float(jgp.predict_mean(jg, jnp.asarray(zi))), rtol=1e-12)


def test_lane_mean_and_predict_match_jax():
    """The baked lane mean (float32 entries of any shape) and the
    ensemble's predict and cluster selection, at 1e-6."""
    ens_j, ens_t = _ensembles()
    rng = np.random.default_rng(2)
    x = rng.normal(2.0, 1.5, (7, 5, 3)).astype(np.float32)
    terms = tl.lane_residual_terms(ens_t, torch.as_tensor(x), cluster=1)
    terms_j = jl.lane_residual_terms(ens_j, jnp.asarray(x), cluster=1)
    assert sorted(terms) == sorted(terms_j) == [1, 3]
    for dim in terms:
        np.testing.assert_allclose(terms[dim].numpy(), np.asarray(terms_j[dim]),
                                   atol=1e-6, rtol=0)
    for zi in rng.normal(2.0, 2.0, (6, 4)):
        zt = torch.as_tensor(zi)
        np.testing.assert_array_equal(te.select_cluster(ens_t, zt).numpy(),
                                      np.asarray(je.select_cluster(ens_j, zi)))
        np.testing.assert_allclose(te.predict(ens_t, zt).numpy(),
                                   np.asarray(je.predict(ens_j, zi)), atol=1e-6)
        xs = np.concatenate([zi, [0.0, 0.0, 0.0]])
        np.testing.assert_allclose(
            te.state_residual_fn(ens_t)(torch.as_tensor(xs), None).numpy(),
            np.asarray(je.state_residual_fn(ens_j)(jnp.asarray(xs), None)),
            atol=1e-6)


def _jax_gp_bicycle(n):
    """The small-n twin of ``bench.make_gp_bicycle``
    (``tests/test_pallas_vde.py:161-194``), as a JAX closure over the port's
    own draw carried across by ``convert``-shaped arrays."""
    ens = fleet.make_gp_bicycle(n).ensemble
    ens_j = je.GPEnsemble(*(jnp.asarray(getattr(ens, f)) for f in
                            te.GPEnsemble._fields[:-2]), ens.out_idx,
                          ens.feat_idx)

    def f(x, u, p):
        base = bicycle_dynamics(x, u, _BP, switch=p[0])
        return jl.add_rows(base, jl.lane_residual_terms(ens_j, x))

    return f


def test_gp_bicycle_draw_matches_bench():
    """``fleet.make_gp_bicycle`` draws the bench's rng(11) ensemble."""
    f = fleet.make_gp_bicycle()
    rng = np.random.default_rng(4)
    x = rng.normal(0.0, 0.4, (7, 16)).astype(np.float32)
    x[3] += 8.0
    u = rng.normal(0.0, 0.5, (2, 16)).astype(np.float32)
    p = np.ones((1, 16), np.float32)
    got = f(*(torch.as_tensor(a) for a in (x, u, p))).numpy()
    want = jax.vmap(jax_bench.make_gp_bicycle(), in_axes=1, out_axes=1)(x, u, p)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-6)


def test_vde_gp_bicycle_matches_jax():
    """The sweep at the small-n twin, n=6 (``tests/test_pallas_vde.py:
    212-224``), against the vmapped linearize, at 2e-5."""
    f_j = _jax_gp_bicycle(6)
    B, N = 4, 4
    xs, us = random_traj(np.random.default_rng(3), B, N, 7, 2)
    ps = np.ones((B, 1), np.float32)
    lin = make_vde(fleet.make_gp_bicycle(6), DT, N, 7, 2, 1, device="cpu")
    got = lin(*(torch.as_tensor(a) for a in (xs, us, ps)))
    assert lin.launches == 0
    F = lambda p: discretize(lambda xx, uu: f_j(xx, uu, p), DT, 1)
    want = jax.vmap(lambda a, b, p: linearize(F(p), a, b))(
        *(jnp.asarray(a) for a in (xs, us, ps)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0)


def test_rk4_gp_bicycle_matches_jax():
    f_j = _jax_gp_bicycle(6)
    B, N = 5, 6
    xs, us = random_traj(np.random.default_rng(21), B, N, 7, 2)
    ps = np.ones((B, 1), np.float32)
    rk4 = make_rk4(fleet.make_gp_bicycle(6), DT, 7, 2, 1, device="cpu")
    defect = rk4.defect(*(torch.as_tensor(a) for a in (xs, us, ps)))
    step = rk4(torch.as_tensor(xs[:, 0]), torch.as_tensor(us)[:, 2],
               torch.as_tensor(ps))
    assert rk4.launches == 0
    F = jax.vmap(lambda x, u, p: discretize(
        lambda xx, uu: f_j(xx, uu, p), DT, 1)(x, u))
    c = jax.vmap(lambda x, u, p: F(x, u, jnp.broadcast_to(p, (N, 1))))(
        xs[:, :-1], us, ps) - xs[:, 1:]
    np.testing.assert_allclose(defect.numpy(), np.asarray(c), atol=2e-5, rtol=0)
    np.testing.assert_allclose(step.numpy(), np.asarray(F(xs[:, 0], us[:, 2], ps)),
                               atol=2e-5, rtol=0)


def test_c3_ticks_match_bench():
    """Three ticks of the c3 fleet (the bench's 32-point ensemble) at B=8,
    N=10, against the bench's on its XLA path."""
    B, N = 8, 10
    tick, init, solver, _ = fleet.build_fleet(
        fleet.make_gp_bicycle(), fleet.switch_on, n_nodes=N, device="cpu")
    tick_j, init_j, _, _ = jax_bench.build_fleet(
        jax_bench.make_gp_bicycle(), lambda v, k, e: np.array([1.0], np.float32),
        n_nodes=N, backend="xla")
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


def test_gp_bicycle_functor_params():
    """The GP bicycle names its functor and C entries (a team functor's),
    and its struct has the layout of ``GPBicycleParamsC`` in
    ``csrc/vde_gp_bicycle.cu``: the bicycle's scalars, then n, then the
    table at the source's capacity."""
    csrc = Path(__file__).resolve().parents[1] / "ad_mpc_tpu_torch" / "csrc"
    src = "\n".join(p.read_text() for p in sorted(csrc.glob("vde*")))
    assert re.search(r"\bVDE_TEAM_ENTRIES\(gp_bicycle, GPBicycleDyn, "
                     r"GPBicycleParamsC\)", src)
    assert tgb.GPBicycleDynamics.cuda_team
    cap = re.search(r"constexpr int GP_POINTS = (\d+), GP_DIMS = (\d+), "
                    r"GP_FEATS = (\d+);", src)
    assert tuple(int(v) for v in cap.groups()) == (
        tgb.GP_POINTS, tgb.GP_DIMS, tgb.GP_FEATS)
    body = re.sub(r"//[^\n]*", "", re.search(
        r"struct GPBicycleParamsC \{(.*?)\};", src, re.S).group(1))
    names = [line.split()[-1].split("[")[0] for line in body.split(";")
             if line.strip()]
    f = fleet.make_gp_bicycle()
    assert (f.nx, f.nu, f.p_dim) == (7, 2, 1)
    assert (f.cuda_functor, f.cuda_entry, f.cuda_rk4_entry) == (
        "GPBicycleDyn", "vde_gp_bicycle", "rk4_gp_bicycle")
    params = f.cuda_params()
    assert [n for n, _ in params._fields_] == names
    assert ctypes.sizeof(params) == 4 * (7 + 1 + 2 * 32 * 4 + 2 * 32 + 2 * 4 + 2)
    ens = f.ensemble
    assert params.n == 32 and params.bike.mass == np.float32(_BP.mass)
    np.testing.assert_allclose(np.ctypeslib.as_array(params.X)[1],
                               ens.x_train[1, 0], rtol=1e-7)
    np.testing.assert_allclose(np.ctypeslib.as_array(params.a)[0],
                               ens.k_inv_y[0, 0] * ens.sigma_f[0, 0], rtol=1e-6)
    np.testing.assert_allclose(np.ctypeslib.as_array(params.inv_l)[0],
                               1.0 / ens.len_scale[0, 0], rtol=1e-7)


def test_gp_bicycle_functor_refuses_what_it_cannot_hold():
    """More points than the table holds, or another layout of features and
    outputs, is refused before any launch."""
    with pytest.raises(ValueError):
        fleet.make_gp_bicycle(33).cuda_params()
    ens = fleet.make_gp_bicycle(8).ensemble
    for other in (ens._replace(feat_idx=(3, 4, 5, 2)), ens._replace(out_idx=(3, 5))):
        with pytest.raises(ValueError):
            tgb.GPBicycleDynamics(other).cuda_params()
    with pytest.raises(ValueError):
        make_vde(tgb.GPBicycleDynamics(ens._replace(out_idx=(3, 5))), DT, 4, 7,
                 2, 1, device="cuda")


def test_gp_least_count_is_under_the_plain_count():
    """The GP's least operations per evaluation (``chip_smoke.gp_ops``) at
    the bench's 32 points: 906 primal, 520 for the gradient, and the
    primal under what ``experiments.opcount`` counts for the plain
    ``lane_gp_mean`` (which scales every point by 1 / l and -0.5), so the
    kernels' bound stays a least bound."""
    import chip_smoke
    from ad_mpc_tpu_torch.experiments.opcount import dyn_counts

    assert chip_smoke.gp_ops(32) == (906, 520)
    dyn, ps = fleet.make_gp_bicycle(32), torch.ones(1)
    plain_gp = (dyn_counts(dyn, 7, 2, ps).primal
                - dyn_counts(fleet.dynamic_bicycle, 7, 2, ps).primal)
    assert chip_smoke.gp_ops(32)[0] < plain_gp
