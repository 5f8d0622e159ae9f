"""Port parity for QuadMPC's dynamics with CUDA functors of their own: the
RDRv linear drag (``QuadDragDynamics``, functor ``QuadDragDyn``), the
dual-state GP (``GPQuadDualDynamics``, functor ``GPQuadDualDyn``) and the
clustered ``quad_residual_fn`` (``GPQuadSelectDynamics``, functor
``GPQuadSelectDyn``: the nearest centroid at every evaluation, or pinned
clusters), the two GP ones with the drag beside them too: their plain
versions, VDE sweeps and RK4 maps against the JAX package, their
parameter structs and tables, their refusal of layouts the functors
cannot hold, and the QuadMPC modes that only the plain backend takes.

Inputs are drawn from a seed with numpy and handed to both packages; the
JAX side runs on the CPU on its XLA path (QuadMPC's solver linearizes
there, not through Pallas). Tolerance 2e-5 (``tests/test_pallas_vde.py``)
in float32; the fitted 60-point GP, whose means are sums of terms up to
2,755 that cancel to under 6 (``tests/test_torch_gp_quad.py``), is compared
in float64, at the same tolerance.
"""

import ctypes
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ad_mpc_tpu.control.mpc import QuadMPC as JaxQuadMPC
from ad_mpc_tpu.control.mpc import quad_spec as jax_quad_spec
from ad_mpc_tpu.learned import ensemble as je
from ad_mpc_tpu.models import quadrotor as jq
from ad_mpc_tpu.ops.integrators import discretize, linearize, linearize_p
from ad_mpc_tpu.utils.io import load_model
from ad_mpc_tpu.utils.math import v_dot_q as jax_v_dot_q
from ad_mpc_tpu_torch import convert
from ad_mpc_tpu_torch.control.mpc import QuadMPC, quad_spec
from ad_mpc_tpu_torch.experiments import quad_fleet
from ad_mpc_tpu_torch.experiments.comparative import prepare_quad_mpc
from ad_mpc_tpu_torch.learned.ensemble import quad_residual_fn
from ad_mpc_tpu_torch.models import gp_quad as tgq
from ad_mpc_tpu_torch.models import quadrotor as tq
from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4, make_vde, vde_plain
from ad_mpc_tpu_torch.ops.integrators import discrete_step
from ad_mpc_tpu_torch.testing import boundary_quad_states, dual_gp_ps, quad_traj

DT = 0.1
_QP = jq.QuadrotorParams()
RDRV = quad_fleet.fitted_rdrv_d()


def _jax_ensemble(ens):
    """The JAX package's GPEnsemble with the port ensemble's arrays."""
    return je.GPEnsemble(**{k: (v if isinstance(v, tuple) else jnp.asarray(v))
                            for k, v in ens._asdict().items()})


@pytest.fixture(scope="module")
def ensembles():
    """{name: (port ensemble, JAX ensemble, dtype)}: the fitted
    ``gp_flagship_c1`` (3 outputs, 1 cluster, 60 points; float64), the
    synthetic 2-cluster 3-output ensemble and a 2-cluster 1-output one on
    the body velocity v_y (feature v_y, output row 8; float32), and the
    JAX package's fitted two-cluster ``gp_flagship_c2`` (2 clusters of 60
    points per output; float64)."""
    fitted_j = load_model("gp_flagship_c1")
    two = quad_fleet.make_quad_gp_ensemble(n=16, clusters=2)
    one = two._replace(**{k: getattr(two, k)[1:2] for k in (
        "x_train", "k_inv_y", "len_scale", "sigma_f", "sigma_n", "y_mean",
        "centroids", "n_valid")})
    one = one._replace(x_train=one.x_train[..., 1:2], len_scale=one.len_scale[..., 1:2],
                       centroids=one.centroids[..., 1:2], out_idx=(8,), feat_idx=(8,))
    c2 = quad_fleet.fitted_ensemble_c2()
    return {"fitted": (convert.gp_ensemble(fitted_j), fitted_j, np.float64),
            "two_clusters": (two, _jax_ensemble(two), np.float32),
            "one_output": (one, _jax_ensemble(one), np.float32),
            "c2": (c2, _jax_ensemble(c2), np.float64)}


def _states(seed=9, n=48, dtype=np.float32):
    """Unit quaternions, body velocities in the ensembles' range, inputs in
    [0, 1]."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 0.7, (n, 13))
    x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    x[:, 7:10] = rng.uniform(-4.0, 6.0, (n, 3))
    u = rng.uniform(0.0, 1.0, (n, 4))
    return x.astype(dtype), u.astype(dtype)


def _jax_dual_dyn(ens, rdrv=None):
    """The dynamics of the JAX package's QuadMPC ensemble mode
    (``ad_mpc_tpu/control/mpc.py:264-283``), with ``rdrv_d``."""
    D, out_idx = len(ens.out_idx), ens.out_idx

    def dyn(x, u, p):
        mu0, cl = p[1:1 + D], p[1 + D:1 + 2 * D].astype(jnp.int32)
        z = je.body_frame_features(x, ens.feat_idx)
        mu = je.predict(ens, z, cluster_idx=cl)
        mu = jnp.where(p[0] > 0.5, mu0, mu).astype(jnp.result_type(x))
        full = jnp.zeros(3, jnp.result_type(x))
        for k, dim in enumerate(out_idx):
            full = full.at[dim - 7].set(mu[k])
        return jq.quad_dynamics(x, u, _QP, rdrv_d=rdrv).at[7:10].add(
            jax_v_dot_q(full, x[3:7]))

    return dyn


def test_fitted_rdrv_copy_equals_the_committed_matrix():
    """``ad_mpc_tpu_torch/data/rdrv_d.npy`` is the JAX package's fitted
    ``results/experiments/gp_flagship/rdrv_d.npy``, bit for bit."""
    committed = (Path(__file__).resolve().parents[1] / "results" / "experiments"
                 / "gp_flagship" / "rdrv_d.npy")
    np.testing.assert_array_equal(RDRV, np.load(committed))
    assert RDRV.shape == (3, 3) and RDRV.dtype == np.float64


def test_drag_dynamics_match_jax():
    """The plain forward, entrywise on a (13, n) slab, against the JAX
    package's ``quad_dynamics(rdrv_d=D)`` and the port's matrix form."""
    x, u = _states()
    dyn = tq.QuadDragDynamics(RDRV)
    got = dyn(torch.as_tensor(x.T), torch.as_tensor(u.T), None).T
    want = jax.vmap(lambda a, b: jq.quad_dynamics(a, b, _QP, RDRV))(x, u)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    mat = torch.func.vmap(lambda a, b: tq.quad_dynamics(a, b, rdrv_d=RDRV))(
        torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), mat.numpy(), atol=2e-5)


def test_drag_vde_and_rk4_match_jax():
    """The sweep and both modes of the RK4 map of the drag dynamics against
    the JAX package's linearization of its discretized ``quad_dynamics(
    rdrv_d=D)``."""
    B, N = 4, 5
    xs, us = quad_traj(np.random.default_rng(13), B, N)
    dyn, p = tq.QuadDragDynamics(RDRV), torch.zeros((B, 0))
    got = make_vde(dyn, DT, N, 13, 4, 0, device="cpu")(
        torch.as_tensor(xs), torch.as_tensor(us), p)
    F = discretize(lambda a, b: jq.quad_dynamics(a, b, _QP, RDRV), DT, 1)
    want = jax.jit(jax.vmap(lambda a, b: linearize(F, a, b)))(xs, us)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    rk4 = make_rk4(dyn, DT, 13, 4, 0, device="cpu")
    defect = rk4.defect(torch.as_tensor(xs), torch.as_tensor(us), p)
    np.testing.assert_allclose(defect.numpy(), np.asarray(want[2]), atol=2e-5)
    step = rk4(torch.as_tensor(xs[:, 0]), torch.as_tensor(us)[:, 1], p)
    np.testing.assert_allclose(
        step.numpy(), np.asarray(jax.jit(jax.vmap(F))(xs[:, 0], us[:, 1])), atol=2e-5)
    assert rk4.launches == 0


@pytest.mark.parametrize("name", ["fitted", "two_clusters", "one_output"])
def test_dual_gp_dynamics_match_jax(ensembles, name):
    """The plain forward (entrywise, on a slab, p per column) against the
    dynamics of the JAX package's QuadMPC ensemble mode, on rows with and
    without the trigger and with every cluster."""
    ens, ens_j, dt = ensembles[name]
    x, u = _states(dtype=dt)
    p = dual_gp_ps(np.random.default_rng(4), x.shape[0], ens, trigger_every=3
                   ).astype(dt)
    dyn = tgq.GPQuadDualDynamics(ens)
    assert dyn.p_dim == p.shape[1]
    got = dyn(torch.as_tensor(x.T), torch.as_tensor(u.T), torch.as_tensor(p.T)).T
    want = jax.vmap(_jax_dual_dyn(ens_j))(x, u, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("name", ["fitted", "two_clusters"])
def test_dual_gp_vde_and_rk4_match_jax_solver(ensembles, name):
    """The sweep and the RK4 map with a p row per scenario against the
    JAX QuadMPC solver's own discrete map (``solver._F``) and its
    per-stage linearization (``linearize_p``)."""
    ens, ens_j, dt = ensembles[name]
    B, N = 6, 2
    xs, us = (a.astype(dt) for a in quad_traj(np.random.default_rng(17), B, N))
    xs[..., 7:10] *= 10.0  # body velocities across the clusters
    ps = dual_gp_ps(np.random.default_rng(5), B, ens, trigger_every=3).astype(dt)
    jmpc = JaxQuadMPC(spec=jax_quad_spec(n_nodes=N, t_horizon=N * DT),
                      ensemble=ens_j, dtype=jnp.float64)
    F = jmpc.solver._F
    want = jax.jit(jax.vmap(
        lambda a, b, p: linearize_p(F, a, b, jnp.tile(p, (N, 1)))))(xs, us, ps)
    dyn = tgq.GPQuadDualDynamics(ens)
    t = lambda a: torch.as_tensor(a)
    got = vde_plain(dyn, DT, 1, t(xs), t(us), t(ps))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    rk4 = make_rk4(dyn, DT, 13, 4, dyn.p_dim, device="cpu")
    np.testing.assert_allclose(rk4.defect(t(xs), t(us), t(ps)).numpy(),
                               np.asarray(want[2]), atol=2e-5)
    step = jax.jit(jax.vmap(F))(xs[:, 0], us[:, 0], ps)
    np.testing.assert_allclose(rk4(t(xs[:, 0]), t(us)[:, 0], t(ps)).numpy(),
                               np.asarray(step), atol=2e-5)


def test_trigger_rows_carry_mu0_with_no_gp_derivative(ensembles):
    """On a trigger row the residual is R(q) mu0 whatever the velocity: its
    Jacobian in v is the nominal quad's (zero), as the functor's lift,
    which reads and caches no GP mean there, assumes."""
    ens, _, _ = ensembles["fitted"]
    dyn = tgq.GPQuadDualDynamics(ens)
    x, u = (torch.as_tensor(a) for a in _states(n=1, dtype=np.float64))
    x, u = x[0], u[0]
    p = torch.tensor([1.0, 0.3, -0.2, 0.5, 0.0, 0.0, 0.0], dtype=torch.float64)
    jac = torch.func.jacfwd(lambda xx: dyn(xx, u, p))(x)
    nominal = torch.func.jacfwd(lambda xx: tq.quad_dynamics_lane(xx, u))(x)
    torch.testing.assert_close(jac[:, 7:10], nominal[:, 7:10], atol=0, rtol=0)
    mu_world = tq.v_dot_q(p[1:4], x[3:7])
    torch.testing.assert_close(dyn(x, u, p)[7:10],
                               tq.quad_dynamics_lane(x, u)[7:10] + mu_world)


def test_drag_struct_holds_d_and_the_quad():
    dyn = tq.QuadDragDynamics(RDRV)
    s = dyn.cuda_params()
    assert ctypes.sizeof(s) == ctypes.sizeof(tq.QuadParamsC) + 9 * 4
    np.testing.assert_array_equal(np.ctypeslib.as_array(s.D),
                                  RDRV.astype(np.float32))
    assert bytes(s.quad) == bytes(tq.QuadDynamics().cuda_params())
    with pytest.raises(ValueError, match="3x3"):
        tq.QuadDragDynamics(np.eye(2))


def _unpack_table(flat, C, n):
    """(X (3, C, n, 3), a (3, C, n), 1/l (3, C, 3), y_mean (3, C)) of a
    functor's table by ``gp_dual_layout``, and whether its padding is 0."""
    lay = tgq.gp_dual_layout(C, n)
    X = np.stack([np.stack([flat[lay["X"](r, c):][:3 * n].reshape(n, 3) for c in range(C)])
                  for r in range(3)])
    a = np.stack([np.stack([flat[lay["a"](r, c):][:n] for c in range(C)]) for r in range(3)])
    inv_l = np.stack([np.stack([flat[lay["inv_l"](r, c):][:3] for c in range(C)])
                      for r in range(3)])
    y_mean = np.array([[flat[lay["y_mean"](r, c)] for c in range(C)] for r in range(3)])
    used = np.zeros(lay["floats"], bool)
    for r in range(3):
        for c in range(C):
            used[lay["X"](r, c):][:3 * n] = used[lay["a"](r, c):][:n] = True
    used[lay["inv_l"](0, 0):] = True
    return X, a, inv_l, y_mean, not flat[:lay["floats"]][~used].any()


def test_dual_gp_table_pads_to_the_body_velocities(ensembles):
    """The functor's table: every cluster of every output, on the body
    velocity it corrects and the features it reads; zeros (a, y_mean, 1/l)
    elsewhere and in the padding of each (output, cluster) block of X and
    a (``gp_dual_layout``); the struct's slots name each output's place
    in p."""
    ens, _, _ = ensembles["one_output"]
    dyn = tgq.GPQuadDualDynamics(ens)
    C, n, D, slot = dyn.cuda_layout()
    assert (C, n, D, slot) == (2, 16, 1, (-1, 0, -1))
    flat = dyn.cuda_table()
    X, a, inv_l, y_mean, zero_pad = _unpack_table(flat, C, n)
    assert zero_pad and flat.dtype == np.float32
    assert flat.size == tgq.gp_dual_layout(C, n)["floats"] == 3 * C * (65 + 33 + 4)
    np.testing.assert_array_equal(X[1, :, :, 1], ens.x_train[0, :, :, 0].astype(np.float32))
    np.testing.assert_array_equal(
        a[1], (ens.k_inv_y[0] * ens.sigma_f[0][:, None]).astype(np.float32))
    np.testing.assert_array_equal(inv_l[1, :, 1], (1.0 / ens.len_scale[0, :, 0]).astype(np.float32))
    np.testing.assert_array_equal(y_mean[1], ens.y_mean[0].astype(np.float32))
    for r in (0, 2):
        assert not a[r].any() and not y_mean[r].any()
    assert not inv_l[:, :, [0, 2]].any() and not X[:, :, :, [0, 2]].any()
    fitted = tgq.GPQuadDualDynamics(ensembles["fitted"][0])
    assert fitted.cuda_layout() == (1, 60, 3, (0, 1, 2))
    assert ctypes.sizeof(tgq.GPQuadDualParamsC) == 160
    assert tgq.GPQuadDualParamsC.table.offset == 88
    assert tgq.GPQuadDualParamsC.drag.offset == 120


def test_dual_gp_functor_refuses_other_layouts(ensembles):
    """A feature or output off the body velocities, a repeated index, more
    clusters or points than the table holds: refused with the layout."""
    ens = ensembles["two_clusters"][0]
    bad = {
        "feat_idx=(7, 8, 3)": ens._replace(feat_idx=(7, 8, 3)),
        "out_idx=(7, 7, 9)": ens._replace(out_idx=(7, 7, 9)),
        "17 clusters": quad_fleet.make_quad_gp_ensemble(n=4, clusters=17),
        "600 points": quad_fleet.make_quad_gp_ensemble(n=300, clusters=2),
    }
    for what, e in bad.items():
        with pytest.raises(ValueError, match="GPQuadDualDyn"):
            tgq.GPQuadDualDynamics(e).cuda_table()
        with pytest.raises(ValueError, match="GPQuadDualDyn"):
            make_vde(tgq.GPQuadDualDynamics(e), DT, 4, 13, 4, 7, device="cuda")


def test_quad_mpc_cuda_refuses_modes_without_a_functor(ensembles):
    """On the cuda backend a residual other than ``quad_residual_fn``, or
    ``residual_fn`` with ``ensemble``, raises NotImplementedError naming
    the ROADMAP item (Queue A 8); the plain backend takes them."""
    fitted = ensembles["fitted"][0]
    for kw in ({"residual_fn": lambda x, u: 0.0 * x},
               {"residual_fn": quad_residual_fn(fitted), "ensemble": fitted}):
        with pytest.raises(NotImplementedError, match="Queue A 8"):
            QuadMPC(spec=quad_spec(), device="cpu", backend="cuda", **kw)
        QuadMPC(spec=quad_spec(), device="cpu", **kw)
    one = QuadMPC(spec=quad_spec(), device="cpu",
                  residual_fn=quad_residual_fn(fitted))
    assert isinstance(one.solver.f, tgq.GPQuadDynamics)


def test_quad_mpc_routes_clustered_and_drag_modes_to_functors(ensembles):
    """A multi-cluster ``quad_residual_fn``, per evaluation or pinned, and
    the drag beside any GP mode take a functor: the select dynamics for
    every ``quad_residual_fn`` beyond one cluster or with the drag, the
    dual-state dynamics with the drag for ``ensemble=`` with ``rdrv_d``;
    so does the comparative experiment's ``gp`` option."""
    c2, fitted = ensembles["c2"][0], ensembles["fitted"][0]
    cases = [({"residual_fn": quad_residual_fn(c2)}, tgq.GPQuadSelectDynamics, None, False),
             ({"residual_fn": quad_residual_fn(c2, 1)}, tgq.GPQuadSelectDynamics,
              (1, 1, 1), False),
             ({"residual_fn": quad_residual_fn(fitted), "rdrv_d": RDRV},
              tgq.GPQuadSelectDynamics, None, True),
             ({"ensemble": fitted, "rdrv_d": RDRV}, tgq.GPQuadDualDynamics, None, True)]
    for kw, cls, pin, drag in cases:
        dyn = QuadMPC(spec=quad_spec(), device="cpu", **kw).solver.f
        assert type(dyn) is cls and dyn.cuda_entry is not None
        assert getattr(dyn, "pin", None) == pin and (dyn.D is not None) == drag
        dyn.cuda_table()  # the layout fits the functor
    # the comparative experiment's gp option on the flagship's two-cluster fit
    gp = prepare_quad_mpc("gp", ensemble=c2, device="cpu").solver.f
    assert type(gp) is tgq.GPQuadSelectDynamics and gp.pin is None


def test_pinned_clusters_index_as_a_jax_gather():
    """``fixed_cluster``: an int for every output or one per output; a
    negative index from the last cluster, the rest clamped."""
    ens = quad_fleet.make_quad_gp_ensemble(n=4, clusters=3)
    assert tgq.pinned_clusters(ens, None) is None
    assert tgq.pinned_clusters(ens, 1) == (1, 1, 1)
    assert tgq.pinned_clusters(ens, [0, -1, 7]) == (0, 2, 2)


def _jax_select_dyn(ens_j, fixed=None, rdrv=None):
    """The dynamics of the JAX package's QuadMPC with
    ``residual_fn=quad_residual_fn(ens, fixed)`` (and ``rdrv_d``)."""
    res = je.quad_residual_fn(ens_j, fixed_cluster=fixed)
    return lambda x, u: jq.quad_dynamics(x, u, _QP, rdrv_d=rdrv) + res(x, u)


def _both_sides(ens, dtype, n=64, seed=21):
    """States with body velocities on both sides of the boundary between the
    first output's two clusters, 1% of the centroids' distance or more off
    it (``testing.boundary_quad_states``), and :func:`_states`."""
    xb, ub = boundary_quad_states(np.random.default_rng(seed), n, ens, offset=0.05)
    x, u = _states(n=n, dtype=dtype)
    return np.concatenate([xb.astype(dtype), x]), np.concatenate([ub.astype(dtype), u])


@pytest.mark.parametrize("pinned", [False, True], ids=["nearest", "pinned"])
@pytest.mark.parametrize("name", ["c2", "two_clusters"])
def test_select_dynamics_match_jax(ensembles, name, pinned):
    """The plain forward (entrywise, on a slab) against the dynamics of the
    JAX package's QuadMPC with ``quad_residual_fn(ens)`` (the nearest
    centroid per evaluation) or ``quad_residual_fn(ens, 1)``, on states on
    both sides of a cluster boundary."""
    ens, ens_j, dt = ensembles[name]
    x, u = _both_sides(ens, dt)
    fixed = 1 if pinned else None
    z = jax.vmap(lambda a: je.body_frame_features(a, ens_j.feat_idx))(x)
    picks = np.asarray(jax.vmap(lambda zz: je.select_cluster(ens_j, zz))(z))
    assert set(picks[:, 0]) == {0, 1}
    dyn = tgq.GPQuadSelectDynamics(ens, fixed_cluster=fixed)
    assert dyn.p_dim == 0
    got = dyn(torch.as_tensor(x.T), torch.as_tensor(u.T), None).T
    want = jax.vmap(_jax_select_dyn(ens_j, fixed))(x, u)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def _jax_solver_maps(ens_j, xs, us, N, **mpc_kw):
    """The JAX QuadMPC solver's per-stage linearization and discrete map
    (``solver._F``) of a p_dim=0 mode: ((A, B, c), F(x_0, u_0))."""
    jmpc = JaxQuadMPC(spec=jax_quad_spec(n_nodes=N, t_horizon=N * DT),
                      dtype=jnp.float64, **mpc_kw)
    F = jmpc.solver._F
    p = jnp.zeros((N, 0))
    lin = jax.jit(jax.vmap(lambda a, b: linearize_p(F, a, b, p)))(xs, us)
    step = jax.jit(jax.vmap(lambda a, b: F(a, b, p[0])))(xs[:, 0], us[:, 0])
    return lin, step


def _hold_plain_maps(dyn, xs, us, ps, lin, step):
    """The plain sweep and both modes of the plain RK4 map of ``dyn``
    against the JAX solver's at 2e-5."""
    t = lambda a: torch.as_tensor(a)
    for g, w in zip(vde_plain(dyn, DT, 1, t(xs), t(us), t(ps)), lin):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    rk4 = make_rk4(dyn, DT, 13, 4, dyn.p_dim, device="cpu")
    np.testing.assert_allclose(rk4.defect(t(xs), t(us), t(ps)).numpy(),
                               np.asarray(lin[2]), atol=2e-5)
    np.testing.assert_allclose(rk4(t(xs[:, 0]), t(us)[:, 0], t(ps)).numpy(),
                               np.asarray(step), atol=2e-5)
    assert rk4.launches == 0


@pytest.mark.parametrize("pinned", [False, True], ids=["nearest", "pinned"])
@pytest.mark.parametrize("name", ["c2", "two_clusters"])
def test_select_vde_and_rk4_match_jax_solver(ensembles, name, pinned):
    """The sweep and the RK4 map of the select dynamics against the JAX
    QuadMPC solver's own discrete map and per-stage linearization, with
    velocities that cross the clusters within a step."""
    ens, ens_j, dt = ensembles[name]
    B, N = 6, 2
    xs, us = (a.astype(dt) for a in quad_traj(np.random.default_rng(17), B, N))
    xs[..., 7:10] *= 5.0 if name == "c2" else 10.0
    fixed = 1 if pinned else None
    lin, step = _jax_solver_maps(
        ens_j, xs, us, N, residual_fn=je.quad_residual_fn(ens_j, fixed_cluster=fixed))
    _hold_plain_maps(tgq.GPQuadSelectDynamics(ens, fixed_cluster=fixed), xs, us,
                     np.zeros((B, 0), dt), lin, step)


@pytest.mark.parametrize("mode", ["select_c2", "select_one_cluster", "dual"])
def test_drag_beside_a_gp_matches_jax_solver(ensembles, mode):
    """``rdrv_d`` with a GP mode: the select dynamics (the two-cluster fit,
    and the one-cluster fit, which the select functor serves with the drag)
    and the dual-state dynamics (p rows with the trigger on every third)
    with the drag, their plain forward, sweep and RK4 map against the JAX
    QuadMPC's dynamics and solver (nominal, then drag, then the GP)."""
    B, N = 6, 2
    xs, us = quad_traj(np.random.default_rng(19), B, N)
    xs, us = xs.astype(np.float64), us.astype(np.float64)
    xs[..., 7:10] *= 5.0
    if mode == "dual":
        ens, ens_j, _ = ensembles["two_clusters"]
        dyn = tgq.GPQuadDualDynamics(ens, rdrv_d=RDRV)
        ps = dual_gp_ps(np.random.default_rng(5), B, ens, trigger_every=3
                        ).astype(np.float64)
        jmpc = JaxQuadMPC(spec=jax_quad_spec(n_nodes=N, t_horizon=N * DT),
                          ensemble=ens_j, rdrv_d=RDRV, dtype=jnp.float64)
        F = jmpc.solver._F
        lin = jax.jit(jax.vmap(
            lambda a, b, p: linearize_p(F, a, b, jnp.tile(p, (N, 1)))))(xs, us, ps)
        step = jax.jit(jax.vmap(F))(xs[:, 0], us[:, 0], ps)
        got = dyn(torch.as_tensor(xs[:, 0].T), torch.as_tensor(us[:, 0].T),
                  torch.as_tensor(ps.T)).T
        want = jax.vmap(_jax_dual_dyn(ens_j, RDRV))(xs[:, 0], us[:, 0], ps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    else:
        ens, ens_j, _ = ensembles["c2" if mode == "select_c2" else "fitted"]
        dyn = tgq.GPQuadSelectDynamics(ens, rdrv_d=RDRV)
        ps = np.zeros((B, 0))
        lin, step = _jax_solver_maps(ens_j, xs, us, N, rdrv_d=RDRV,
                                     residual_fn=je.quad_residual_fn(ens_j))
        x, u = (_both_sides(ens, np.float64) if ens.n_clusters > 1
                else _states(dtype=np.float64))
        got = dyn(torch.as_tensor(x.T), torch.as_tensor(u.T), None).T
        want = jax.vmap(_jax_select_dyn(ens_j, rdrv=RDRV))(x, u)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    _hold_plain_maps(dyn, xs, us, ps, lin, step)


def test_select_struct_and_table(ensembles):
    """The select functor's struct mirrors the source; its table is the
    dual functor's (one packer) with each output's centroids appended in
    the ensemble's feature order; its pins sit on the body velocities, 0
    on those that are no output."""
    ens = ensembles["one_output"][0]
    dyn = tgq.GPQuadSelectDynamics(ens, fixed_cluster=1)
    assert dyn.cuda_layout() == (2, 16, 1, (1, 0, 0), (0, 1, 0))
    C, n = 2, 16
    flat = dyn.cuda_table()
    dual = tgq.GPQuadDualDynamics(ens).cuda_table()
    np.testing.assert_array_equal(flat[:dual.size], dual)
    assert flat.size == tgq.gp_dual_layout(C, n)["select_floats"] == dual.size + 9 * C + 3
    lay = tgq.gp_dual_layout(C, n)
    cen = np.stack([flat[lay["centroids"](r):][:3 * C] for r in range(3)]).reshape(3, C, 3)
    assert not flat[lay["centroids"](1) - 1] and not flat[lay["centroids"](2) - 1]
    np.testing.assert_array_equal(cen[1, :, 0], ens.centroids[0, :, 0].astype(np.float32))
    assert not cen[[0, 2]].any() and not cen[:, :, 1:].any()
    c2 = tgq.GPQuadSelectDynamics(ensembles["c2"][0])
    assert c2.cuda_layout() == (2, 60, 3, (0, 1, 2), (-1, -1, -1))
    assert ctypes.sizeof(tgq.GPQuadSelectParamsC) == 176
    assert tgq.GPQuadSelectParamsC.table.offset == 88
    assert tgq.GPQuadSelectParamsC.pin.offset == 120
    assert tgq.GPQuadSelectParamsC.drag.offset == 132
    assert ctypes.sizeof(tgq.QuadDragOptC) == 40
    src = (Path(tgq.__file__).resolve().parents[1] / "csrc" / "vde_gp_quad_select.cu").read_text()
    for field in ("const float* table;", "int clusters, n;", "int d_feat;", "int feat[3];",
                  "int pin[3];", "QuadDragOptC drag;"):
        assert field in src


def test_select_functor_refuses_other_layouts(ensembles):
    """A feature or output off the body velocities, a repeated index, more
    clusters or points than the table holds: refused with the layout."""
    ens = ensembles["two_clusters"][0]
    bad = {
        "feat_idx=(7, 8, 3)": ens._replace(feat_idx=(7, 8, 3)),
        "out_idx=(7, 7, 9)": ens._replace(out_idx=(7, 7, 9)),
        "17 clusters": quad_fleet.make_quad_gp_ensemble(n=4, clusters=17),
        "600 points": quad_fleet.make_quad_gp_ensemble(n=300, clusters=2),
    }
    for what, e in bad.items():
        with pytest.raises(ValueError, match="GPQuadSelectDyn"):
            tgq.GPQuadSelectDynamics(e).cuda_table()
        with pytest.raises(ValueError, match="GPQuadSelectDyn"):
            make_vde(tgq.GPQuadSelectDynamics(e), DT, 4, 13, 4, 0, device="cuda")
