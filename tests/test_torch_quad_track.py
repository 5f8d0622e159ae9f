"""Port parity for the quadrotor tracking loop (``run_tracking``, the
reference's smoke test) and the fleet solver's oracle distance at the
deployed c2 settings.

``run_tracking`` runs float32 on the CPU's plain versions for 25 ticks of
the loop at 8 m/s under the flagship's drag (deterministic), nominal,
with the dual-state fitted GP and with ``quad_residual_fn`` of the fitted
two-cluster GP, against the JAX package's loop of the same functions (its QuadMPC in float32, its plant with x64): every applied u0
within 1e-3 and the RMSE within 1e-3 m.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ad_mpc_tpu.control.mpc import QuadMPC as JaxQuadMPC
from ad_mpc_tpu.control.mpc import quad_spec as jax_quad_spec
from ad_mpc_tpu.experiments import quad_trajectory_test as jtt
from ad_mpc_tpu.learned import GPEnsemble as JaxGPEnsemble
from ad_mpc_tpu.learned.ensemble import quad_residual_fn as jax_quad_residual_fn
from ad_mpc_tpu.sim.simulator import DisturbanceConfig as JaxDisturbanceConfig
from ad_mpc_tpu.sim.simulator import QuadrotorSim as JaxQuadrotorSim
from ad_mpc_tpu.utils.io import load_model
from ad_mpc_tpu.utils.math import interpol_mse as jax_interpol_mse
from ad_mpc_tpu_torch import convert
from ad_mpc_tpu_torch.experiments import quad_fleet
from ad_mpc_tpu_torch.experiments import quad_trajectory_test as tt
from ad_mpc_tpu_torch.learned.ensemble import quad_residual_fn
from ad_mpc_tpu_torch.sim.simulator import DisturbanceConfig
from ad_mpc_tpu_torch.testing import fleet_oracle_distance
from ad_mpc_tpu_torch.testing import one_thread  # noqa: F401 (autouse)


TICKS = 25


def _jax_tracking(steps, **mpc_kw):
    """The loop of the JAX package's ``run_tracking`` (loop, 8 m/s, drag
    only, seed 0), with the applied u0 of every tick."""
    traj, t_ref, u_traj = jtt.loop_trajectory(v_max=8.0, radius=5.0)
    spec = jax_quad_spec(qp_iters=15)
    mpc = JaxQuadMPC(spec=spec, dtype=jnp.float32, **mpc_kw)
    sim = JaxQuadrotorSim(disturbances=JaxDisturbanceConfig(drag=True))
    x, key = jnp.asarray(traj[0]), jax.random.PRNGKey(0)
    u0s, states, times = [], [], []
    for step in range(steps):
        t_now = step * 0.02
        x_ref, u_ref = jtt.get_reference_chunk(traj, u_traj, t_ref, t_now, 10, spec.dt)
        mpc.set_reference(x_ref, u_ref)
        us, _ = mpc.optimize(x)
        u0s.append(np.asarray(us[0]))
        x, key = sim.step(x, us[0], key, 0.02)
        states.append(np.asarray(x))
        times.append(t_now + 0.02)
    rmse = float(jax_interpol_mse(np.asarray(times), np.stack(states)[:, :3],
                                  t_ref, traj[:, :3]))
    return np.stack(u0s), rmse


def _modes(model):
    """(JAX QuadMPC keywords, the port's run_tracking keywords) of a row:
    nominal, the dual-state fitted GP, and ``quad_residual_fn`` of the
    fitted two-cluster ``gp_flagship_c2`` (the nearest centroid at every
    evaluation)."""
    if model == "nominal":
        return {}, {}
    if model == "gp":
        fitted = load_model("gp_flagship_c1")
        return {"ensemble": fitted}, {"ensemble": convert.gp_ensemble(fitted)}
    c2 = quad_fleet.fitted_ensemble_c2()
    c2_j = JaxGPEnsemble(**{k: (v if isinstance(v, tuple) else jnp.asarray(v))
                            for k, v in c2._asdict().items()})
    return ({"residual_fn": jax_quad_residual_fn(c2_j)},
            {"residual_fn": quad_residual_fn(c2)})


@pytest.mark.parametrize("model", ["nominal", "gp", "residual_fn_c2"])
def test_run_tracking_matches_jax(model):
    jax_kw, kw = _modes(model)
    u0_j, rmse_j = _jax_tracking(TICKS, **jax_kw)
    res = tt.run_tracking(disturbances=DisturbanceConfig(drag=True),
                          max_steps=TICKS, device="cpu", **kw)
    assert res.n_steps == TICKS and res.u0s.shape == (TICKS, 4)
    np.testing.assert_allclose(res.u0s, u0_j, atol=1e-3, rtol=0)
    assert abs(res.rmse - rmse_j) < 1e-3
    assert res.launches == {"vde": 0, "lq_ipm": 0, "rk4": 0}
    assert res.n_resets == 0 and np.isfinite(res.p99_opt_ms)


def test_reference_chunk_matches_jax():
    traj, t_ref, u_traj = tt.reference("lemniscate", 6.0)
    for t_now in (0.0, 0.37, 5.0, float(t_ref[-1]) + 1.0):
        got = tt.get_reference_chunk(traj, u_traj, t_ref, t_now, 10, 0.1)
        want = jtt.get_reference_chunk(traj, u_traj, t_ref, t_now, 10, 0.1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tt.reference("spiral", 6.0)


def test_fleet_solver_reaches_the_oracle_at_c2_settings():
    """The committed oracle instance (N=20) through ``BatchedSQPSolver`` at
    the deployed c2 settings (one Gauss-Newton iteration, 12 IPM
    iterations, float32, broadcast p; plain versions on the CPU): after 30
    RTI re-solves u0 lies within 1e-3 of the oracle's."""
    path = os.path.join(os.path.dirname(__file__), "fixtures", "oracle_bike_n20.npz")
    d, launches = fleet_oracle_distance(path, "cpu")
    assert d < 1e-3, d
    assert launches == {"vde": 0, "lq_ipm": 0, "rk4": 0}
