"""Port parity for ``QuadMPC`` (``ad_mpc_tpu/control/mpc.py:221-400``) on
the plain backend in float64: three consecutive solves with the shifted
warm start in each of the modes the JAX package's callers use (nominal,
the fitted RDRv drag, ``quad_residual_fn`` of the fitted one-cluster GP,
the dual-state GP ``ensemble=`` on
``tests/test_learned.py:TestDualStateGP``'s two-cluster model,
``quad_residual_fn`` of the fitted two-cluster ``gp_flagship_c2``, the
nearest centroid at every evaluation and pinned to cluster 1, and the
drag beside the dual-state and the one-cluster GP) within 1e-9 of the JAX
package's u0; mirrors of ``TestDualStateGP``; the solver-health
watchdog; and the quaternion retraction's guard.

One difference from the reference is by design: the RTI retraction
divides the warm start's quaternions by max(norm, 1e-8), where the JAX
package divides by the norm unguarded (ROADMAP Queue C 4); on every
warm start a solve meets, the norms are far from 1e-8 and the bits agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ad_mpc_tpu.control.mpc import QuadMPC as JaxQuadMPC
from ad_mpc_tpu.control.mpc import quad_spec as jax_quad_spec
from ad_mpc_tpu.learned import GPEnsemble as JaxGPEnsemble
from ad_mpc_tpu.learned import fit_gp
from ad_mpc_tpu.learned.ensemble import quad_residual_fn as jax_quad_residual_fn
from ad_mpc_tpu.ocp.solver import SolverState as JaxSolverState
from ad_mpc_tpu.utils.io import load_model
from ad_mpc_tpu_torch import convert
from ad_mpc_tpu_torch.control.mpc import QuadMPC, quad_spec
from ad_mpc_tpu_torch.experiments import quad_fleet
from ad_mpc_tpu_torch.experiments.quad_trajectory_test import get_reference_chunk
from ad_mpc_tpu_torch.learned.ensemble import quad_residual_fn
from ad_mpc_tpu_torch.ocp.solver import SolverState
from ad_mpc_tpu_torch.trajectories import loop_trajectory

F64 = torch.float64


@pytest.fixture(scope="module")
def models():
    """{mode: (JAX QuadMPC kwargs, port QuadMPC kwargs)}; the two-cluster
    model fitted once with the JAX package's ``fit_gp`` as
    ``TestDualStateGP`` fits it, carried across by ``convert``."""
    rng = np.random.default_rng(7)
    gps = [[]]
    for center in (-2.0, 2.0):
        X = center + rng.uniform(-1.2, 1.2, (20, 1))
        y = 0.3 * np.sign(center) + 0.2 * np.sin(X[:, 0])
        gps[0].append(fit_gp(X, y, n_restarts=2))
    two_j = JaxGPEnsemble.from_gps(gps, out_idx=(7,), feat_idx=(7,))
    fitted_j = load_model("gp_flagship_c1")
    fitted, two = convert.gp_ensemble(fitted_j), convert.gp_ensemble(two_j)
    c2 = quad_fleet.fitted_ensemble_c2()
    c2_j = JaxGPEnsemble(**{k: (v if isinstance(v, tuple) else jnp.asarray(v))
                            for k, v in c2._asdict().items()})
    D = quad_fleet.fitted_rdrv_d()
    return {
        "nominal": ({}, {}),
        "rdrv": ({"rdrv_d": D}, {"rdrv_d": D}),
        "residual_fn": ({"residual_fn": jax_quad_residual_fn(fitted_j)},
                        {"residual_fn": quad_residual_fn(fitted)}),
        "ensemble": ({"ensemble": two_j}, {"ensemble": two}),
        "residual_fn_c2": ({"residual_fn": jax_quad_residual_fn(c2_j)},
                           {"residual_fn": quad_residual_fn(c2)}),
        "residual_fn_c2_pinned": ({"residual_fn": jax_quad_residual_fn(c2_j, 1)},
                                  {"residual_fn": quad_residual_fn(c2, 1)}),
        "rdrv_gp": ({"rdrv_d": D, "ensemble": two_j}, {"rdrv_d": D, "ensemble": two}),
        "rdrv_residual_fn": ({"rdrv_d": D, "residual_fn": jax_quad_residual_fn(fitted_j)},
                             {"rdrv_d": D, "residual_fn": quad_residual_fn(fitted)}),
    }


@pytest.fixture(scope="module")
def loop():
    return loop_trajectory(v_max=8.0, radius=5.0)


def _pair(kj, kt, **spec_kw):
    spec_kw.setdefault("qp_iters", 15)
    return (JaxQuadMPC(spec=jax_quad_spec(**spec_kw), dtype=jnp.float64, **kj),
            QuadMPC(spec=quad_spec(**spec_kw), dtype=F64, device="cpu", **kt))


@pytest.mark.parametrize("mode", ["nominal", "rdrv", "residual_fn", "ensemble",
                                  "residual_fn_c2", "residual_fn_c2_pinned",
                                  "rdrv_gp", "rdrv_residual_fn"])
def test_quad_mpc_matches_jax(models, loop, mode):
    """Three solves with the shifted warm start along the loop at 8 m/s, the
    plant moved between them; in GP mode a second state for node 0."""
    traj, t_ref, u_traj = loop
    jmpc, mpc = _pair(*models[mode])
    x = traj[300].copy()
    for k in range(3):
        x_ref, u_ref = get_reference_chunk(traj, u_traj, t_ref, 6.0 + 0.02 * k,
                                           10, 0.1)
        jmpc.set_reference(x_ref, u_ref)
        mpc.set_reference(x_ref, u_ref)
        gp_x = x.copy()
        gp_x[7] += 0.5
        kw = {"gp_x0": gp_x} if "ensemble" in models[mode][1] else {}
        uj, xj = jmpc.optimize(x, **kw)
        ut, xt = mpc.optimize(torch.as_tensor(x), **kw)
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-9, rtol=0)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-9, rtol=0)
        np.testing.assert_allclose(mpc.state.xs.numpy(), np.asarray(jmpc.state.xs),
                                   atol=1e-9, rtol=0)
        x = np.asarray(xj)[1] + 0.01
    if "ensemble" in models[mode][1]:
        np.testing.assert_array_equal(mpc.last_cluster, np.asarray(jmpc.last_cluster))
    assert mpc.n_resets == jmpc.n_resets == 0


def _hover():
    x = np.zeros(13)
    x[3] = 1.0
    return x


def _dual(models):
    return QuadMPC(ensemble=models["ensemble"][1]["ensemble"], dtype=F64,
                   device="cpu", spec=quad_spec(n_nodes=6, t_horizon=0.6, qp_iters=8))


def test_gp_state_changes_node0_only(models):
    """``TestDualStateGP.test_gp_state_changes_node0_only``: gp_x0 = x0 is
    the default, and an EKF state in the other cluster's region moves the
    plan."""
    mpc, x0 = _dual(models), _hover()
    ref = np.zeros((7, 13))
    ref[:, 3] = 1.0
    ref[:, 2] = 1.0
    mpc.set_reference(ref)
    us_a, _ = mpc.optimize(x0, gp_x0=x0)
    mpc.reset()
    us_b, _ = mpc.optimize(x0)
    torch.testing.assert_close(us_a, us_b, atol=1e-7, rtol=0)
    mpc.reset()
    gp_x = x0.copy()
    gp_x[7] = 2.0
    us_c, _ = mpc.optimize(x0, gp_x0=gp_x)
    assert float((us_c - us_a).abs().max()) > 1e-5


def test_midpoint_cluster_selection(models):
    """``TestDualStateGP.test_midpoint_cluster_selection``: the cluster is
    the nearest centroid at the warm start's horizon midpoint."""
    mpc, x0 = _dual(models), _hover()
    ref = np.zeros((7, 13))
    ref[:, 3] = 1.0
    mpc.set_reference(ref)
    N = mpc.spec.n_nodes
    for v, want in ((2.0, 1), (-2.0, 0)):
        xs = np.tile(x0, (N + 1, 1))
        xs[:, 7] = v
        mpc.state = SolverState(xs=torch.as_tensor(xs), us=torch.zeros((N, 4), dtype=F64))
        mpc.optimize(x0)
        assert isinstance(mpc._last_cluster, torch.Tensor)
        assert int(mpc.last_cluster[0]) == want


def test_watchdog_resets_and_keeps_no_poisoned_iterate(models):
    """A warm start whose controls are NaN: the first solve is not finite,
    the solver resets to the current state and re-solves (one reset), and
    the stored iterate is finite, as the JAX package's. A state at 500 m/s
    stays implausible from a cold start too: no iterate is kept."""
    jmpc, mpc = _pair(*models["nominal"])
    x0 = _hover()
    x0[2] = 1.0
    ref = np.tile(x0, (11, 1))
    for m in (jmpc, mpc):
        m.set_reference(ref)
    N = mpc.spec.n_nodes
    xs, us = np.tile(x0, (N + 1, 1)), np.full((N, 4), np.nan)
    jmpc.state = JaxSolverState(xs=jnp.asarray(xs), us=jnp.asarray(us))
    mpc.state = SolverState(xs=torch.as_tensor(xs), us=torch.as_tensor(us))
    uj, _ = jmpc.optimize(x0)
    ut, _ = mpc.optimize(torch.as_tensor(x0))
    assert mpc.n_resets == jmpc.n_resets == 1
    assert bool(torch.isfinite(mpc.state.xs).all())
    assert float(mpc.state.xs[:, 7:10].abs().max()) < QuadMPC.HEALTH_LIMIT
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-9, rtol=0)
    fast = x0.copy()
    fast[7] = 500.0
    uj, _ = jmpc.optimize(fast)
    ut, _ = mpc.optimize(torch.as_tensor(fast))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-9, rtol=0)
    assert mpc.n_resets == jmpc.n_resets == 2
    assert mpc.state is None and jmpc.state is None


def test_quaternion_guard_keeps_a_zero_warm_start_finite(models):
    """A warm start whose quaternions are all zero: the guarded retraction
    (max(norm, 1e-8)) keeps the solve finite with no reset, where the JAX
    package's unguarded division gives NaN and its watchdog resets."""
    mpc = QuadMPC(spec=quad_spec(), dtype=F64, device="cpu")
    x0 = _hover()
    mpc.set_reference(np.tile(x0, (11, 1)))
    N = mpc.spec.n_nodes
    xs = np.tile(x0, (N + 1, 1))
    xs[:, 3:7] = 0.0
    mpc.state = SolverState(xs=torch.as_tensor(xs), us=torch.zeros((N, 4), dtype=F64))
    us, xs_out = mpc.optimize(torch.as_tensor(x0))
    assert mpc.n_resets == 0
    assert bool(torch.isfinite(us).all()) and bool(torch.isfinite(xs_out).all())
    jmpc = JaxQuadMPC(spec=jax_quad_spec(), dtype=jnp.float64)
    jmpc.set_reference(np.tile(x0, (11, 1)))
    jmpc.state = JaxSolverState(xs=jnp.asarray(xs), us=jnp.zeros((N, 4)))
    jmpc.optimize(x0)
    assert jmpc.n_resets == 1
