"""Port parity of the single-vehicle AD path against the JAX package on the
CPU: the reference layer, the safety shell, the bicycle plant, the
controller facade (``BicycleMPC``: backup gate, fused step, point
reference) and a short closed loop on the oval.

Float64 at 1e-9 for the reference layer and the noise-free plant (the JAX
side with x64 on, as ``tests/conftest.py`` sets it); the safety functions
exactly; u0 within 1e-3 tick by tick in the float32 closed loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ad_mpc_tpu.control import reference as jax_reference
from ad_mpc_tpu.control import safety as jax_safety
from ad_mpc_tpu.control.mpc import BicycleMPC as JaxBicycleMPC
from ad_mpc_tpu.control.mpc import bicycle_spec as jax_bicycle_spec
from ad_mpc_tpu.experiments import ad_closed_loop as jax_closed_loop
from ad_mpc_tpu.sim.simulator import BicycleSim as JaxBicycleSim
from ad_mpc_tpu_torch import convert
from ad_mpc_tpu_torch.control import reference, safety
from ad_mpc_tpu_torch.control.mpc import BicycleMPC
from ad_mpc_tpu_torch.experiments import ad_closed_loop
from ad_mpc_tpu_torch.sim.simulator import BicycleSim, DisturbanceConfig

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain path's small operations run fastest on one thread, and the
    test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oval_window(start, n=200):
    tx, ty, tpsi = ad_closed_loop.oval_track()
    idx = (start + np.arange(n)) % len(tx)
    return tx[idx], ty[idx], tpsi[idx], np.full(n, 8.0)


def _close(got, want, atol=1e-9):
    for g, w in zip(got, want):
        np.testing.assert_allclose(torch.as_tensor(g).double().numpy(),
                                   np.asarray(w, np.float64), atol=atol)


# The windows: the bottom straight, both half-circles, and the top straight
# into the left turn, whose heading crosses the +-pi seam.
WINDOWS = [0, 120, 300, 470]


def test_oval_track_matches_jax():
    for a, b in zip(ad_closed_loop.oval_track(), jax_closed_loop.oval_track()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("start", WINDOWS)
def test_make_path_matches_jax(start):
    w = _oval_window(start)
    _close(reference.make_path(*w, dtype=F64), jax_reference.make_path(*w))


@pytest.mark.parametrize("v_now", [None, 2.0, 8.0])
@pytest.mark.parametrize("start", WINDOWS)
def test_get_waypoints_matches_jax(start, v_now):
    """Off the path by (0.3, -0.2) m and 0.05 rad, as the closed loop finds
    the car; with ``v_now``, the enveloped window."""
    w = _oval_window(start)
    pose = (w[0][3] + 0.3, w[1][3] - 0.2, w[2][3] + 0.05)
    kw = {} if v_now is None else {"v_now": v_now}
    got = reference.get_waypoints(reference.make_path(*w, dtype=F64), *pose,
                                  41, 0.05, **kw)
    want = jax_reference.get_waypoints(jax_reference.make_path(*w), *pose,
                                       41, 0.05, **kw)
    _close(got, want)


def test_yaw_seam_and_stop_flag_match_jax():
    """A heading just past +pi wraps to -pi (psi_init on the seam, the path
    crossing it), and a short path's window runs off its end: the stop
    flag."""
    th = np.linspace(0.0, np.pi, 60)
    x, y = 10 * np.cos(th), 10 * np.sin(th)
    psi = (th + np.pi / 2 + np.pi) % (2 * np.pi) - np.pi
    vel = np.full(60, 6.0)
    for pose in ((x[30], y[30], np.pi - 1e-3), (x[30], y[30], -np.pi + 1e-3),
                 (x[55], y[55], psi[55])):
        got = reference.get_waypoints(reference.make_path(x, y, psi, vel, dtype=F64),
                                      *pose, 21, 0.1)
        want = jax_reference.get_waypoints(jax_reference.make_path(x, y, psi, vel),
                                           *pose, 21, 0.1)
        _close(got, want)
        assert bool(got.stop) == bool(want.stop)
    assert bool(got.stop)  # the last pose's window runs off the path


def test_path_reference_enveloped_and_resample_vel_match_jax():
    w = _oval_window(300)
    ref, ref_j = (reference.PathReference(41, 0.05, dtype=F64),
                  jax_reference.PathReference(41, 0.05))
    ref.set_traj(*w)
    ref_j.set_traj(*w)
    pose = (w[0][5], w[1][5] + 0.4, w[2][5])
    _close(ref.get_waypoints_enveloped(*pose, 3.0),
           ref_j.get_waypoints_enveloped(*pose, 3.0))
    v_ref = np.linspace(2.0, 14.0, 41)
    _close([reference.resample_vel(torch.as_tensor(v_ref), 6.0, 0.05)],
           [jax_reference.resample_vel(jnp.asarray(v_ref), 6.0, 0.05)])
    with pytest.raises(RuntimeError):
        reference.PathReference().get_waypoints(0.0, 0.0, 0.0)


def test_safety_functions_match_jax_exactly():
    ref = np.zeros((11, 7))
    ref[:, 0] = np.arange(11.0)
    rng = np.random.default_rng(3)
    for shift in (0.5, 2.5, 3.5, 10.0):
        x_opt = ref.copy()
        x_opt[:, 1] += shift * rng.uniform(0.5, 1.5, 11)
        assert (bool(safety.is_valid_command(torch.as_tensor(x_opt), torch.as_tensor(ref)))
                == bool(jax_safety.is_valid_command(x_opt, ref)))
    x_now = np.zeros(7)
    for jump, nan in ((0.0, False), (4.9, False), (100.0, False), (0.0, True)):
        x_opt = np.zeros((11, 7))
        if nan:
            x_opt[3, 2] = np.nan
        assert (bool(safety.check_pred_traj(torch.as_tensor(x_opt),
                                            torch.as_tensor(x_now + jump)))
                == bool(jax_safety.check_pred_traj(x_opt, x_now + jump)))
    us = np.arange(20.0).reshape(10, 2)
    np.testing.assert_array_equal(safety.backup_control(torch.as_tensor(us)).numpy(),
                                  np.asarray(jax_safety.backup_control(us)))
    (u, s), (uj, sj) = safety.brake_command(0.2), jax_safety.brake_command(0.2)
    np.testing.assert_array_equal(u.numpy(), np.asarray(uj))
    assert s == sj
    gate, gate_j = safety.ArmingGate(3), jax_safety.ArmingGate(3)
    for ok in (True, True, True, False, True, True, True, True):
        assert gate.update(ok) == gate_j.update(ok) and gate.count == gate_j.count


# Plant cases: cruising, hard steering into the clip, braking to a stop
# (brake-stops-at-standstill), accelerating from rest.
PLANT = [([0.0, 0.0, 0.1, 8.0, 0.1, 0.05, 0.2], [1.0, 0.5], 0.05),
         ([1.0, 2.0, -2.0, 6.0, 0.0, 0.0, 0.5], [0.0, 3.0], 0.05),
         ([0.0, 0.0, 0.0, 0.3, 0.0, 0.0, 0.0], [-10.0, 0.0], 0.05),
         ([0.0, 0.0, 3.1, 0.0, 0.0, 0.0, -0.1], [4.0, -1.0], 0.02)]


@pytest.mark.parametrize("x,u,dt", PLANT)
def test_bicycle_sim_step_matches_jax(x, u, dt):
    got = BicycleSim().step(torch.tensor(x, dtype=F64), torch.tensor(u), dt)
    want, _ = JaxBicycleSim().step(jnp.asarray(x), jnp.asarray(u),
                                   jax.random.PRNGKey(0), dt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9)
    assert got.dtype == F64


def test_bicycle_sim_noise_is_seeded_and_scaled():
    """The noisy modes cannot draw jax.random's numbers: they are held to
    determinism under a seed and to the stated scale. The gaussian force
    noise w ~ N(0, (0.5 h)^2) adds w dt to v_x over a period in the
    kinematic regime; motor noise moves the command by 0.02 sqrt|u| z."""
    x = torch.tensor([0.0, 0.0, 0.0, 5.0, 0.0, 0.0, 0.0], dtype=F64)
    u, dt = torch.tensor([1.0, 0.2]), 0.05
    clean = BicycleSim().step(x, u, dt)
    noisy = BicycleSim(disturbances=DisturbanceConfig(noisy=True), seed=4)
    again = BicycleSim(disturbances=DisturbanceConfig(noisy=True), seed=4)
    a, b = noisy.step(x, u, dt), again.step(x, u, dt)
    assert torch.equal(a, b) and a.shape == (7,)
    h = dt / round(dt / 1e-3)
    gen = torch.Generator().manual_seed(4)
    w = torch.randn(2, generator=gen, dtype=F64) * 0.5 * h
    np.testing.assert_allclose(float(a[3] - clean[3]), float(w[0]) * dt, atol=1e-12)
    motor = BicycleSim(disturbances=DisturbanceConfig(motor_noise=True), seed=4)
    m = motor.step(x, u, dt)
    z = torch.randn(2, generator=torch.Generator().manual_seed(4), dtype=F64)
    np.testing.assert_allclose(float(m[3] - clean[3]),
                               0.02 * float(z[0]) * dt, atol=1e-12)
    assert not torch.equal(a, clean)
    assert torch.equal(noisy.step(a, u, dt), again.step(b, u, dt))


def _reference_rows(n=11, v=5.0):
    good = np.zeros((n, 7))
    good[:, 0] = np.linspace(0.0, v * 0.05 * (n - 1), n)
    good[:, 3] = v
    return good


def test_optimize_backup_gate_matches_jax():
    """``tests/test_mpc_closed_loop.py:test_backup_control_on_bad_reference``
    on both packages: a plausible solve, then a reference 100 m off, which
    the gate rejects and answers with the shifted previous plan."""
    spec_j = jax_bicycle_spec(n_nodes=10, t_horizon=0.5, qp_iters=8)
    mpc = BicycleMPC(spec=convert.ocp_spec(spec_j), device="cpu")
    mpc_j = JaxBicycleMPC(spec=spec_j)
    x = np.zeros(7)
    x[3] = 5.0
    good = _reference_rows()
    bad = good.copy()
    bad[:, 1] += 100.0
    for ref in (good, bad):
        mpc.set_reference(ref)
        mpc_j.set_reference(ref)
        us, _, ok = mpc.optimize(torch.as_tensor(x))
        us_j, _, ok_j = mpc_j.optimize(jnp.asarray(x, jnp.float32))
        assert ok == ok_j
        np.testing.assert_allclose(us.numpy(), np.asarray(us_j), atol=1e-5)
    assert not ok


def test_optimize_matches_the_fused_step():
    """The node's fused step and ``optimize`` solve the same problem from
    the same cold start: u0 within 1e-6, tick after tick, and the health
    flag is the plausibility gate's."""
    spec = convert.ocp_spec(jax_bicycle_spec(n_nodes=12, t_horizon=0.6, qp_iters=10))
    mpc, fused_mpc = (BicycleMPC(spec=spec, device="cpu") for _ in range(2))
    step = fused_mpc.make_fused_step()
    x = torch.tensor([0.0, 0.3, 0.05, 5.0, 0.0, 0.0, 0.1])
    ref = _reference_rows(13)
    carry = fused_mpc.fused_init(x)
    for _ in range(3):
        mpc.set_reference(ref)
        us, _, ok = mpc.optimize(x)
        packed = torch.cat([x[None], torch.as_tensor(ref, dtype=torch.float32)])
        out, *carry = step(packed, *carry)
        assert float((out[:2] - us[0]).abs().max()) < 1e-6
        assert bool(out[3] > 0.5) == ok
        np.testing.assert_allclose(float(out[2]), float(torch.clamp(
            x[6] + us[0, 1] * 0.1, -0.52, 0.52)), atol=1e-7)
        ref[:, 0] += 0.25


def test_point_reference_mode_matches_jax():
    """Full SQP (10 Gauss-Newton iterations, 6 line-search candidates) on a
    single point target, in float64 on both packages."""
    spec_j = jax_bicycle_spec(n_nodes=10, t_horizon=0.5, qp_iters=10)
    mpc = BicycleMPC(spec=convert.ocp_spec(spec_j), point_reference=True,
                     dtype=F64, device="cpu")
    mpc_j = JaxBicycleMPC(spec=spec_j, point_reference=True, dtype=jnp.float64)
    assert (mpc.spec.sqp_iters, mpc.spec.ls_steps) == (10, 6)
    target = np.array([[3.0, 0.8, 0.2, 0.0, 0.0, 0.0, 0.0]])
    x = np.array([0.0, 0.0, 0.0, 2.0, 0.0, 0.0, 0.0])
    mpc.set_reference(target)
    mpc_j.set_reference(target)
    us, xs, ok = mpc.optimize(torch.as_tensor(x))
    us_j, xs_j, ok_j = mpc_j.optimize(jnp.asarray(x))
    assert ok == ok_j
    np.testing.assert_allclose(us.numpy(), np.asarray(us_j), atol=1e-9)
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_j), atol=1e-9)


def test_closed_loop_matches_jax(monkeypatch):
    """40 ticks on the oval at N=12: each tick's u0 within 1e-3 of the JAX
    package's and the tracking RMSE within 1e-3 m (the solver float32 in
    both, the plant and the reference window float64)."""
    u0_jax = []
    optimize = JaxBicycleMPC.optimize

    def recording(self, x0, use_backup_gate=True):
        us, xs, ok = optimize(self, x0, use_backup_gate)
        u0_jax.append(np.asarray(us[0], np.float64))
        return us, xs, ok

    monkeypatch.setattr(JaxBicycleMPC, "optimize", recording)
    kw = dict(sim_time=40 * 0.05, n_nodes=12, t_horizon=0.6, qp_iters=10)
    want = jax_closed_loop.run_closed_loop(**kw)
    got = ad_closed_loop.run_closed_loop(**kw, device="cpu", ref_dtype=F64)
    assert got.n_steps == want.n_steps == len(u0_jax) == 40
    assert np.abs(got.u0s - np.stack(u0_jax)).max() < 1e-3
    assert abs(got.rmse_pos - want.rmse_pos) < 1e-3
    assert got.launches == {"vde": 0, "lq_ipm": 0, "rk4": 0}


def test_bench_holds_the_ad_rows_to_their_gates():
    from ad_mpc_tpu_torch import bench as port_bench

    detail = {"configs": {}, "errors": {},
              "ad_closed_loop": {"rmse_pos": 0.6},
              "deployment_loop_50hz": {"tracking_rmse_m": 0.1},
              "deployment_aggr_nolagcomp": {"tracking_rmse_m": 2.78}}
    failures = port_bench.gate_failures(detail)
    assert [f.split("=")[0] for f in failures] == [
        "ad_closed_loop.rmse_pos", "deployment_aggr_nolagcomp.tracking_rmse_m"]
    ports = [kw["base_port"] for kw in port_bench.DEPLOY_ROWS.values()]
    assert len(set(ports)) == len(ports) and min(abs(a - b) for a in ports
                                                 for b in ports if a != b) >= 4
