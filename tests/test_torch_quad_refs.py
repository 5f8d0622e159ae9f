"""Port parity for the quadrotor's host side: the trajectory library (each
case of ``tests/test_trajectories.py``, the port's arrays equal to the JAX
package's and the same feasibility checks), the quaternion helpers and the
plant, ``QuadrotorSim`` (float64 within 1e-9 of the JAX package over a
period in the deterministic modes; in the noisy modes deterministic per
seed, with the motor bias's sign).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ad_mpc_tpu.trajectories as jt
from ad_mpc_tpu.sim.simulator import DisturbanceConfig as JaxDisturbanceConfig
from ad_mpc_tpu.sim.simulator import QuadrotorSim as JaxQuadrotorSim
from ad_mpc_tpu.utils import math as jm
import ad_mpc_tpu_torch.trajectories as tt
from ad_mpc_tpu_torch.sim.simulator import DisturbanceConfig, QuadrotorSim
from ad_mpc_tpu_torch.utils import math as tm

# (generator, arguments) of every trajectory tests/test_trajectories.py draws.
CASES = {
    "loop": ("loop_trajectory", {"v_max": 6.0}),
    "loop_yawing": ("loop_trajectory", {"v_max": 6.0, "yawing": True}),
    "loop_ccw": ("loop_trajectory", {"v_max": 6.0, "clockwise": False}),
    "lemniscate": ("lemniscate_trajectory", {"v_max": 6.0}),
    "loop_8": ("loop_trajectory", {"v_max": 8.0}),
    "straight": ("straight_trajectory", {"start": np.array([0.0, 0.0, 1.0]),
                                         "end": np.array([8.0, 2.0, 1.5]),
                                         "speed": 3.0}),
    "random": ("random_trajectory", {"seed": 3, "duration": 12.0,
                                     "n_keyframes": 6}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_equals_jax(case):
    name, kw = CASES[case]
    got = getattr(tt, name)(**kw)
    want = getattr(jt, name)(**kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    atol = (2e-2, 2e-3, 0.1) if case == "random" else (1e-2, 1e-3, 0.05)
    if case != "loop_8":
        ok, errs = tt.check_trajectory(*got[::2], got[1], atol=atol)
        assert ok, errs
    traj, t, u = got
    if case == "loop_8":  # test_loop_reaches_vmax
        assert abs(np.max(np.linalg.norm(traj[:, 7:10], axis=1)) - 8.0) < 0.5
    if case == "loop":  # test_inputs_in_range
        assert np.min(u) > -0.05 and np.max(u) < 1.0
    if case == "straight":
        np.testing.assert_allclose(traj[-1, :3] - traj[0, :3], [8.0, 2.0, 0.5],
                                   atol=0.05)


def test_polynomial_and_keyframes_equal_jax():
    t_knots = np.array([0.0, 1.0, 2.5, 4.0])
    wps = np.array([[0, 0, 1], [1, 1, 2], [2, -1, 1.5], [3, 0, 1]], dtype=float)
    coeffs = tt.fit_multi_segment_polynomial(t_knots, wps)
    np.testing.assert_array_equal(coeffs, jt.fit_multi_segment_polynomial(t_knots, wps))
    derivs, t = tt.sample_polynomial_trajectory(coeffs, t_knots, 0.01)
    want_d, want_t = jt.sample_polynomial_trajectory(coeffs, t_knots, 0.01)
    np.testing.assert_array_equal(derivs, want_d)
    np.testing.assert_array_equal(t, want_t)
    for i, tk in enumerate(t_knots[:-1]):
        np.testing.assert_allclose(derivs[0][:, int(np.searchsorted(t, tk))],
                                   wps[i], atol=1e-4)
    limits = ((-4.0, 4.0), (-3.0, 3.0), (0.5, 2.5))
    kf, theta = tt.random_periodical_keyframes(12, map_limits=limits, seed=1)
    want_kf, want_theta = jt.random_periodical_keyframes(12, map_limits=limits, seed=1)
    np.testing.assert_array_equal(kf, want_kf)
    np.testing.assert_array_equal(theta, want_theta)
    np.testing.assert_allclose(kf[0], kf[-1])


def test_validator_rejects_bad_trajectory():
    traj, t, u = tt.loop_trajectory(v_max=6.0)
    bad = traj.copy()
    bad[:, 7] += 1.0
    assert not tt.check_trajectory(bad, u, t)[0]
    assert tt.check_trajectory(bad, u, t)[1] == jt.check_trajectory(bad, u, t)[1]


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(16, 4))
    r = rng.normal(size=(16, 4))
    v = rng.normal(size=(16, 3))
    qt, rt, vt = (torch.as_tensor(a) for a in (q, r, v))
    qu = q / np.linalg.norm(q, axis=1, keepdims=True)
    rot = np.asarray(jm.q_to_rot_mat(qu))
    rpy = rng.uniform(-1.2, 1.2, (3, 16))
    pairs = [
        (tm.skew_3d(vt), jm.skew_3d(v)),
        (tm.unit_quat(qt), jm.unit_quat(q)),
        (tm.q_dot_q(qt, rt), jm.q_dot_q(q, r)),
        (tm.quaternion_to_euler(torch.as_tensor(qu)), jm.quaternion_to_euler(qu)),
        (tm.euler_to_quaternion(*torch.as_tensor(rpy)), jm.euler_to_quaternion(*rpy)),
        (tm.rotation_matrix_to_quat(torch.as_tensor(rot)), jm.rotation_matrix_to_quat(rot)),
        (tm.undo_quaternion_flip(qt, -rt), jm.undo_quaternion_flip(q, -r)),
        (tm.quaternion_state_mse(torch.as_tensor(np.r_[v[0], qu[0], v[1], v[2]]),
                                 torch.as_tensor(np.r_[v[3], qu[1], v[4], v[5]]),
                                 np.linspace(0.5, 1.5, 12)),
         jm.quaternion_state_mse(np.r_[v[0], qu[0], v[1], v[2]],
                                 np.r_[v[3], qu[1], v[4], v[5]],
                                 np.linspace(0.5, 1.5, 12))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9, rtol=0)
    # The Shepperd extraction recovers the quaternion up to sign.
    back = tm.rotation_matrix_to_quat(torch.as_tensor(rot)).numpy()
    assert np.allclose(np.abs(np.sum(back * qu, axis=1)), 1.0, atol=1e-12)
    t1, t2 = np.linspace(0, 1, 30), np.linspace(0, 1.2, 50)
    x1, x2 = rng.normal(size=(30, 3)), rng.normal(size=(50, 3))
    assert abs(tm.interpol_mse(t1, x1, t2, x2)
               - float(jm.interpol_mse(t1, x1, t2, x2))) < 1e-12


def _plant_state(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=13)
    x[3:7] /= np.linalg.norm(x[3:7])
    x[7:10] *= 3.0
    return x, rng.uniform(0.2, 0.6, 4)


@pytest.mark.parametrize("mode", ["drag", "payload", "drag_payload", "none"])
def test_quad_sim_matches_jax(mode):
    """One 20 ms period (40 RK4 sub-steps of 0.5 ms, the quaternion
    renormalized after each) in float64 within 1e-9 of the JAX package."""
    kw = {"drag": {"drag": True}, "payload": {"payload": True},
          "drag_payload": {"drag": True, "payload": True}, "none": {}}[mode]
    x, u = _plant_state()
    want, _ = JaxQuadrotorSim(disturbances=JaxDisturbanceConfig(**kw)).step(
        jnp.asarray(x), jnp.asarray(u), jax.random.PRNGKey(0), 0.02)
    got = QuadrotorSim(disturbances=DisturbanceConfig(**kw)).step(
        torch.as_tensor(x), torch.as_tensor(u), 0.02)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9, rtol=0)
    assert abs(np.linalg.norm(got.numpy()[3:7]) - 1.0) < 1e-12


def test_quad_sim_noise_is_seeded_and_the_motor_bias_slows():
    """The noisy modes draw from the simulator's generator: the same seed
    gives the same bits, another seed another state. Motor noise has a
    positive bias 0.1 (u/1.3)^2: over many periods from hover the thrust
    falls short, so the quad sinks against the noiseless plant."""
    x, u = _plant_state(1)
    dist = DisturbanceConfig(noisy=True, motor_noise=True)
    run = lambda seed: QuadrotorSim(disturbances=dist, seed=seed).step(
        torch.as_tensor(x), torch.as_tensor(u), 0.02)
    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    hover = np.zeros(13)
    hover[3] = 1.0
    u_hover = np.full(4, 9.81 / 80.0)
    z = {}
    for name, d in (("clean", DisturbanceConfig()),
                    ("motor", DisturbanceConfig(motor_noise=True))):
        sim, s = QuadrotorSim(disturbances=d, seed=0), torch.as_tensor(hover)
        for _ in range(25):
            s = sim.step(s, torch.as_tensor(u_hover), 0.02)
        z[name] = float(s[2])
    assert abs(z["clean"]) < 1e-9 and z["motor"] < -1e-3
