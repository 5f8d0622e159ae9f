"""Port parity for the quadrotor mission node
(``ad_mpc_tpu/nodes/quad_node.py``): both packages' nodes driven by one
scripted MPC through one script of (x, t, seq) that covers every phase,
drops and a doubled optimization (the phases, the references handed to
the MPC, the returned controls, the skipped count, the RMSE and the
recording equal; the nominal prediction within 1e-9 in float64); the
port's node with QuadMPC on the plain backend in float64 against the JAX
node for 30 optimized messages (u0 within 1e-9, the tolerance of
``test_torch_quad_mpc.py``); and the port's own straight mission through
every phase within the gates of ``tests/test_quad_mission.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ad_mpc_tpu.control.mpc import QuadMPC as JaxQuadMPC
from ad_mpc_tpu.control.mpc import quad_spec as jax_quad_spec
from ad_mpc_tpu.models.quadrotor import QuadrotorParams as JaxQuadrotorParams
from ad_mpc_tpu.nodes.quad_node import QuadMissionNode as JaxMissionNode
from ad_mpc_tpu_torch.control.mpc import QuadMPC, quad_spec
from ad_mpc_tpu_torch.experiments.quad_mission import run_mission, straight_mission
from ad_mpc_tpu_torch.models.quadrotor import QuadrotorParams
from ad_mpc_tpu_torch.nodes import quad_node
from ad_mpc_tpu_torch.nodes.quad_node import MissionPhase, QuadMissionNode
from ad_mpc_tpu_torch.testing import one_thread  # noqa: F401


def mission_script(seed=3):
    """(reference, events): the straight mission's reference and a list of
    ("load",) or (x, t, seq) events: hover, the reference loaded, ascend,
    track past the reference's end, land, off; a dropped message every
    13th and two every 29th."""
    (traj, t_ref, u_traj), x_start = straight_mission()
    rng = np.random.default_rng(seed)
    states = []

    def state(p, v=(0.0, 0.0, 0.0), noise=0.01):
        x = np.zeros(13)
        x[:3] = np.asarray(p) + noise * rng.normal(size=3)
        x[3:7] = [1.0, 0.0, 0.0, 0.0] + 0.01 * rng.normal(size=4)
        x[7:10] = np.asarray(v) + 0.02 * rng.normal(size=3)
        x[10:13] = 0.05 * rng.normal(size=3)
        return x

    states += [state([0.0, 0.0, 0.5]) for _ in range(6)]
    states.append("load")
    states += [state([0.0, 0.0, 0.7], v=[0.0, 0.0, 0.4]) for _ in range(4)]
    states += [state(x_start[:3], noise=0.02) for _ in range(3)]
    n_track = int((t_ref[-1] + 0.3) / 0.01)
    for k in range(n_track):
        i = min(k, len(traj) - 1)
        states.append(state(traj[i, :3], v=traj[i, 7:10], noise=0.03))
    states += [state([2.0, 0.0, z], v=[0.0, 0.0, -0.2]) for z in
               np.linspace(0.8, 0.12, 12)]
    states += [state([2.0, 0.0, 0.1]) for _ in range(4)]
    events, seq = [], 0
    for s in states:
        if isinstance(s, str):
            events.append((s,))
            continue
        seq += 1
        seq += 1 if seq % 13 == 0 else 2 if seq % 29 == 0 else 0
        events.append((s, 0.01 * seq, seq))
    return (traj, t_ref, u_traj), events


class ScriptedMPC:
    """Hands out one seeded list of (us, xs) in float64 and records each
    reference; ``tensors`` returns them as CPU tensors (the port's
    QuadMPC returns tensors on its device). Float64, as QuadMPC in float64
    gives them: under a float32 u the JAX node's nominal prediction rounds
    its thrust terms in float32 (its ``jnp`` type promotion), where the
    port's runs in float64 throughout."""

    def __init__(self, spec, params, tensors, n=600, seed=4):
        rng = np.random.default_rng(seed)
        N = spec.n_nodes
        self.spec, self.params, self.tensors = spec, params, tensors
        self.outs = [(rng.uniform(0.1, 0.6, (N, 4)), rng.normal(size=(N + 1, 13)))
                     for _ in range(n)]
        self.refs, self.k = [], 0

    def set_reference(self, ref, u_ref):
        self.refs.append((np.array(ref), np.array(u_ref)))

    def optimize(self, x):
        us, xs = self.outs[self.k]
        self.k += 1
        if self.tensors:
            return torch.as_tensor(us), torch.as_tensor(xs)
        return us, xs


def test_scripted_mission_equals_jax(monkeypatch):
    ref, events = mission_script()
    port = QuadMissionNode(mpc=ScriptedMPC(quad_spec(), QuadrotorParams(), True),
                           record=True)
    jax_node = JaxMissionNode(mpc=ScriptedMPC(jax_quad_spec(), JaxQuadrotorParams(),
                                              False), record=True)
    # The same map compiled: eager, its 160 evaluations a row take seconds.
    jax_node._nominal_F = jax.jit(jax_node._nominal_F)
    fetches = []
    fetch = quad_node.fetch_solution
    monkeypatch.setattr(quad_node, "fetch_solution",
                        lambda us, xs: fetches.append(1) or fetch(us, xs))
    got, want = [], []
    for ev in events:
        for node, out in ((port, got), (jax_node, want)):
            if len(ev) == 1:
                node.receive_trajectory(*ref)
            else:
                out.append((np.array(node.step(*ev)), node.phase.value))
    assert [p for _, p in got] == [p for _, p in want]
    assert {p for _, p in got} == {m.value for m in MissionPhase}
    for (u, _), (v, _) in zip(got, want):
        np.testing.assert_array_equal(u, v)
    assert port.mpc.k == jax_node.mpc.k == len(fetches) == port.n_optimized
    for (r, ur), (s, us) in zip(port.mpc.refs, jax_node.mpc.refs):
        np.testing.assert_array_equal(r, s)
        np.testing.assert_array_equal(ur, us)
    assert port.n_skipped == jax_node.n_skipped > 0
    assert port.tracking_rmse() == jax_node.tracking_rmse()
    np.testing.assert_array_equal(port.last_xs, jax_node.last_xs)
    rec, jrec = port.recording_arrays(), jax_node.recording_arrays()
    assert len(rec[0]) > 20
    for i, (a, b) in enumerate(zip(rec, jrec)):
        if i == 3:  # the nominal prediction, 40 RK4 sub-steps in float64
            assert a.dtype == np.float64
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)
        else:
            np.testing.assert_array_equal(a, b)
    # A doubled optimization: two optimized messages in a row, after a drop.
    seqs = [ev[2] for ev in events if len(ev) == 3]
    assert any(b - a > 2 for a, b in zip(seqs, seqs[1:]))


def test_real_mpc_mission_u0_equals_jax():
    """QuadMPC (plain, float64) in the port's node and the JAX package's
    QuadMPC (float64) in its node, the first 30 optimized messages."""
    ref, events = mission_script(seed=8)
    port = QuadMissionNode(mpc=QuadMPC(spec=quad_spec(), dtype=torch.float64,
                                       device="cpu"))
    jax_node = JaxMissionNode(mpc=JaxQuadMPC(spec=jax_quad_spec(), dtype=jnp.float64))
    n, seen = 0, set()
    for ev in events:
        if len(ev) == 1:
            port.receive_trajectory(*ref)
            jax_node.receive_trajectory(*ref)
            continue
        before = port.n_optimized
        u = port.step(*ev)
        v = jax_node.step(*ev)
        assert port.phase.value == jax_node.phase.value
        np.testing.assert_allclose(u, np.asarray(v), atol=1e-9, rtol=0)
        n += port.n_optimized - before
        seen.add(port.phase.value)
        if n >= 30:
            break
    assert n == 30
    assert {"hover", "ascend", "track"} <= seen
    np.testing.assert_allclose(port.last_xs, jax_node.last_xs, atol=1e-9, rtol=0)


def test_straight_mission_through_every_phase():
    """``tests/test_quad_mission.py``'s flight on the plain backend:
    ascend, track and land seen, off below land_z + 0.1, RMSE < 0.5 m, and
    the recording's nominal prediction nearer the next state than standing
    still."""
    ref, x0 = straight_mission()
    node = QuadMissionNode(mpc=QuadMPC(spec=quad_spec(qp_iters=10), device="cpu"),
                           control_period=0.02, optimize_every=2, record=True)
    res = run_mission(node, *ref, x0, max_steps=1200)
    assert {"ascend", "track", "land"} <= res.seen
    assert node.phase == MissionPhase.OFF
    assert res.x_final[2] < node.land_z + 0.1
    assert node.tracking_rmse() < 0.5
    x_in, u, x_out, x_pred, dt = node.recording_arrays()
    assert x_in.shape[1] == 13 and u.shape[1] == 4
    assert x_out.shape == x_in.shape == x_pred.shape
    err_pred = np.linalg.norm(x_out - x_pred, axis=1).mean()
    err_hold = np.linalg.norm(x_out - x_in, axis=1).mean()
    assert err_pred < err_hold
    assert len(res.solve_ms) == node.n_optimized


@pytest.mark.slow
def test_jax_loop_mission_reference():
    """The JAX package's mission node (float32 QuadMPC, 18 IPM iterations,
    its nominal map compiled) on ``run_mission``'s loop script: 50 hover
    messages from the ground, the loop at 8 m/s loaded, on to OFF, the
    plant without disturbance. Its RMSE is ``chip_smoke.JAX_MISSION_RMSE``,
    whose 1.25 x gates the port's loop mission on the card."""
    import chip_smoke
    from ad_mpc_tpu.nodes.quad_node import MissionPhase as JaxPhase
    from ad_mpc_tpu.nodes.reference_publisher import ReferenceGenerator
    from ad_mpc_tpu.sim.simulator import DisturbanceConfig, QuadrotorSim

    ref = ReferenceGenerator(mode="loop", velocities=(8.0,)).next_trajectory()
    node = JaxMissionNode(record=True)
    node._nominal_F = jax.jit(node._nominal_F)
    sim = QuadrotorSim(disturbances=DisturbanceConfig())
    x = np.zeros(13)
    x[2], x[3] = 0.1, 1.0
    key, t, seen = jax.random.PRNGKey(0), 0.0, set()
    for k in range(4000):
        if k == 50:
            node.receive_trajectory(*ref)
        u = node.step(np.asarray(x), t)
        x, key = sim.step(jnp.asarray(x), jnp.asarray(u), key, 0.02)
        x, t = np.asarray(x), t + 0.02
        seen.add(node.phase.value)
        if node.phase == JaxPhase.OFF:
            break
    assert seen == {m.value for m in MissionPhase}
    assert node.tracking_rmse() == pytest.approx(chip_smoke.JAX_MISSION_RMSE["loop"],
                                                 rel=1e-9)
