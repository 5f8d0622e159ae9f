"""Port parity for the quadrotor's deployment layer
(``ad_mpc_tpu/nodes/{quad_wrapper,reference_publisher,quad_controller}.py``):
the xacro and its parameters, the ControlCommand and both codecs, the
reference generator's arrays, the mission node's skipped-message gating
(``tests/test_quad_deployment.py:77-118``), the publisher's busy handshake
against a scripted subscriber, a dense reference through the bridge's
fragments, the controller's command and the plant node's odometry; and,
marked slow as in the JAX package, the two-node UDP loop with drops.

Ports 48700-48739: none of the JAX tests', ``topics.py``'s or the other
port tests'.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from ad_mpc_tpu.models.quadrotor import QuadrotorParams as JaxQuadrotorParams
from ad_mpc_tpu.nodes import quad_controller as jax_ctrl
from ad_mpc_tpu.nodes import quad_wrapper as jw
from ad_mpc_tpu.nodes import reference_publisher as jrp
from ad_mpc_tpu_torch.models.quadrotor import QuadrotorParams
from ad_mpc_tpu_torch.nodes import quad_controller as ctrl
from ad_mpc_tpu_torch.nodes import quad_wrapper as tw
from ad_mpc_tpu_torch.nodes import reference_publisher as trp
from ad_mpc_tpu_torch.nodes.quad_node import QuadMissionNode
from ad_mpc_tpu_torch.runtime import Publisher, Subscriber, bridge
from ad_mpc_tpu_torch.testing import one_thread  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "test_quad.xacro")
BASE = 48700


# ------------------------------------------------------------ the wrapper

@pytest.mark.parametrize("name", ["test_quad", "hummingbird"])
def test_xacro_params_equal_jax(name):
    assert tw.parse_xacro_file(FIXTURE) == jw.parse_xacro_file(FIXTURE)
    got = tw.quad_params_from_xacro(FIXTURE, quad_name=name)
    want = jw.quad_params_from_xacro(FIXTURE, quad_name=name)
    assert tuple(got) == tuple(want)
    assert got.configuration == ("+" if name == "hummingbird" else "x")
    assert abs(got.mass - (0.9 + 4 * 0.025)) < 1e-12
    assert abs(got.max_thrust - 1100.0**2 * 1.2e-5) < 1e-9


@pytest.mark.parametrize("stage", ["2d", "1d"])
def test_control_command_and_codec_equal_jax(stage):
    rng = np.random.default_rng(5)
    us = rng.uniform(0, 1, (6, 4)).astype(np.float32)
    xs = rng.normal(size=(7, 13))
    if stage == "1d":
        us = us[0]
    kw = dict(t=1.25, armed=False, thrust_offset=-1.8)
    got = tw.to_control_command(us, xs, QuadrotorParams(), **kw)
    want = jw.to_control_command(us, xs, JaxQuadrotorParams(), **kw)
    enc = tw.encode_control_command(got)
    np.testing.assert_array_equal(enc, jw.encode_control_command(want))
    np.testing.assert_array_equal(got.bodyrates, xs[1, 10:13])
    back = tw.decode_control_command(enc)
    assert (back.t, back.control_mode, back.armed) == (1.25, 2, False)
    assert back.collective_thrust == got.collective_thrust
    np.testing.assert_array_equal(back.rotor_thrusts, got.rotor_thrusts)
    jback = jw.decode_control_command(enc)
    np.testing.assert_array_equal(jback.bodyrates, back.bodyrates)


# --------------------------------------------------- the reference generator

@pytest.mark.parametrize("mode", ["loop", "lemniscate", "random", "hover"])
def test_reference_generator_equals_jax(mode):
    kw = dict(mode=mode, velocities=(6.0, 3.0), seeds=(0, 1))
    got, want = trp.ReferenceGenerator(**kw), jrp.ReferenceGenerator(**kw)
    assert got._queue == want._queue == [(0, 6.0), (0, 3.0), (1, 6.0), (1, 3.0)]
    assert len(got) == 4
    for _ in range(2 if mode == "random" else 1):
        g, w = got.next_trajectory(), want.next_trajectory()
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
        msg = trp.encode_reference(*g)
        np.testing.assert_array_equal(msg, jrp.encode_reference(*w))
        for a, b, c in zip(trp.decode_reference(msg), jrp.decode_reference(msg), g):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, c, atol=1e-12, rtol=0)
    while got.next_trajectory() is not None:
        pass
    assert got.next_trajectory() is None
    with pytest.raises(ValueError):
        trp.ReferenceGenerator(mode="spiral")


def test_dense_reference_passes_the_bridge_whole():
    """A loop at 8 m/s at 0.01 s is 3,600 x 17 float64s, eight fragments."""
    traj, t_ref, inputs = trp.ReferenceGenerator(mode="loop").next_trajectory()
    msg = trp.encode_reference(traj, t_ref, inputs)
    assert msg.nbytes > 5 * bridge.FRAGMENT_BYTES
    sub, pub = Subscriber(BASE), Publisher(BASE)
    try:
        pub.publish(7, msg)
        tag, got = sub.receive(timeout_ms=2000)
        pub.publish(3, np.arange(4.0))  # a short message after a long one
        assert sub.receive(timeout_ms=2000)[0] == 3
    finally:
        sub.close()
        pub.close()
    assert tag == 7
    traj2, t2, inputs2 = trp.decode_reference(got)
    np.testing.assert_array_equal(traj2, traj)
    np.testing.assert_array_equal(inputs2, inputs)
    np.testing.assert_allclose(t2, t_ref, atol=1e-12, rtol=0)


def test_fragments_of_a_newer_message_drop_the_partial_one():
    sub = Subscriber(BASE + 1)
    try:
        def frag(msg_id, i, count, payload):
            head = np.array([bridge.FRAGMENT_MAGIC, msg_id, i, count], np.uint32)
            return head.tobytes() + payload

        whole = bridge.encode(5, np.arange(10.0))
        assert sub._reassemble(frag(1, 0, 2, whole[:30])) is None
        # Message 2 starts before message 1 completes: 1 is dropped whole.
        assert sub._reassemble(frag(2, 1, 2, whole[30:])) is None
        assert sub._reassemble(frag(1, 1, 2, whole[30:])) is None
        tag, arr = sub._reassemble(frag(1, 0, 2, whole[:30]))
        np.testing.assert_array_equal(arr, np.arange(10.0))
    finally:
        sub.close()


# ------------------------------------------------------- the busy handshake

class ScriptedBusy:
    """A busy subscriber replaying a script: ``None`` entries time out."""

    def __init__(self, queued, script):
        self.queued, self.script = list(queued), list(script)
        self.drained = 0

    def receive(self, timeout_ms=100):
        if timeout_ms == 0:
            if self.queued:
                self.drained += 1
                return self.queued.pop(0)
            return None
        if not self.script:
            time.sleep(timeout_ms / 1e3)
            return None
        b = self.script.pop(0)
        return None if b is None else (10, np.array([b], np.uint8))


class RecordingPub:
    def __init__(self):
        self.sent = []

    def publish(self, tag, arr):
        self.sent.append((tag, arr))


def _publisher(queued, script):
    busy = ScriptedBusy(queued, script)
    node = trp.ReferencePublisherNode(trp.ReferenceGenerator(mode="hover", seeds=(0, 1)),
                                      publisher=RecordingPub(), busy_subscriber=busy)
    return node, busy


def test_handshake_drains_stale_and_needs_busy_first():
    stale = [(10, np.array([0], np.uint8))] * 3
    # A busy=False before any busy=True does not release the reference.
    node, busy = _publisher(stale, [False, None, True, True, False, True, False])
    tic = time.monotonic()
    assert node.run(poll_ms=1, timeout_s=5.0) == 2
    assert time.monotonic() - tic < 2.0
    assert busy.drained == 3 and busy.script == []
    assert len(node.pub.sent) == 2 and node.pub.sent[0][0] == 7


def test_handshake_wait_is_bounded():
    node, _ = _publisher([], [])  # a dead controller: nothing ever arrives
    tic = time.monotonic()
    assert node.run(poll_ms=10, max_trajectories=1, timeout_s=0.3) == 1
    assert 0.3 <= time.monotonic() - tic < 2.0


# --------------------------------------- the gating (test_quad_deployment.py)

def _node():
    return QuadMissionNode(n_nodes=6, t_horizon=0.6, device="cpu")


def _hover():
    x = np.zeros(13)
    x[3] = 1.0
    return x


def test_even_cadence_alternates():
    node, x = _node(), _hover()
    flags = []
    for seq in range(1, 9):
        node.step(x, 0.01 * seq, seq=seq)
        flags.append(not node._optimize_next)
    assert flags == [True, False] * 4
    assert node.n_optimized == 4


def test_odd_drop_before_skip_tick_optimizes_now():
    node, x = _node(), _hover()
    node.step(x, 0.00, seq=1)
    node.step(x, 0.01, seq=3)  # seq 2 dropped (odd): optimize now
    assert node.n_skipped == 1 and not node._optimize_next
    node.step(x, 0.02, seq=4)  # a skip tick
    assert node._optimize_next and node.n_optimized == 2


def test_drop_on_optimize_tick_forces_double():
    node, x = _node(), _hover()
    node.step(x, 0.00, seq=1)
    node.step(x, 0.01, seq=2)
    node.step(x, 0.02, seq=5)  # seqs 3, 4 dropped on an optimize tick
    assert node.n_skipped == 2 and node._optimize_next
    node.step(x, 0.03, seq=6)  # the double-up optimization
    assert not node._optimize_next and node.n_optimized == 3


# ------------------------------------------------ the controller and plant

class StubMPC:
    """A scripted MPC shared by both packages' nodes."""

    def __init__(self, spec, params, us, xs, as_tensor):
        self.spec, self.params = spec, params
        self.us, self.xs, self.as_tensor = us, xs, as_tensor

    def set_reference(self, ref, u_ref):
        pass

    def optimize(self, x):
        if self.as_tensor:
            return torch.as_tensor(self.us), torch.as_tensor(self.xs)
        return self.us, self.xs


def test_controller_command_equals_jax():
    from ad_mpc_tpu.control.mpc import quad_spec as jax_quad_spec
    from ad_mpc_tpu.nodes.quad_node import QuadMissionNode as JaxMissionNode
    from ad_mpc_tpu_torch.control.mpc import quad_spec

    rng = np.random.default_rng(9)
    us = rng.uniform(0.2, 0.5, (10, 4)).astype(np.float32)
    xs = rng.normal(size=(11, 13)).astype(np.float32)
    port = ctrl.QuadControllerNode(
        mission=QuadMissionNode(mpc=StubMPC(quad_spec(), QuadrotorParams(), us, xs, True)),
        state_port=BASE + 10, control_port=BASE + 11, reference_port=BASE + 12,
        busy_port=BASE + 13)
    jax_node = jax_ctrl.QuadControllerNode(
        mission=JaxMissionNode(mpc=StubMPC(jax_quad_spec(), JaxQuadrotorParams(), us, xs,
                                           False)),
        state_port=BASE + 14, control_port=BASE + 15, reference_port=BASE + 16,
        busy_port=BASE + 17)
    try:
        assert not port.busy
        for seq in range(1, 5):
            msg = np.concatenate([[float(seq), 0.01 * seq], rng.normal(size=13)])
            np.testing.assert_array_equal(port.handle_state(msg),
                                          jax_node.handle_state(msg))
        traj, t_ref, inputs = trp.ReferenceGenerator(mode="hover").next_trajectory()
        port.mission.receive_trajectory(traj, t_ref, inputs)
        assert port.busy and port.n_steps == 4
    finally:
        port.close()
        for s in (jax_node.state_sub, jax_node.ref_sub, jax_node.control_pub,
                  jax_node.busy_pub):
            s.close()


def test_sim_node_publishes_sequenced_odometry_and_applies_thrusts():
    """Two ticks at a command, a third dropped: the odometry's [seq, t, x]
    and the plant's states equal the JAX plant node's within 1e-9."""
    cmd = np.concatenate([[0.0, 2.0, 1.0, 9.0], np.zeros(3), [5.5, 5.0, 5.0, 5.5]])
    states = {}
    for pkg, make in (("port", ctrl.QuadSimNode), ("jax", jax_ctrl.QuadSimNode)):
        sp, cp = (BASE + 20, BASE + 21) if pkg == "port" else (BASE + 22, BASE + 23)
        node = make(rate_hz=100.0, state_port=sp, control_port=cp, drop_every=3)
        odo, cmd_pub = Subscriber(sp), Publisher(cp)
        try:
            got = []
            for _ in range(3):
                cmd_pub.publish(9, cmd)
                time.sleep(0.01)
                node.tick()
                got.append(odo.receive(timeout_ms=200))
        finally:
            odo.close()
            cmd_pub.close()
            node.state_pub.close()
            node.control_sub.close()
        assert got[2] is None  # seq 3 dropped
        states[pkg] = (np.stack([g[1] for g in got[:2]]), np.stack(node.states),
                       np.asarray(node.x))
    (om, sm, xm), (oj, sj, xj) = states["port"], states["jax"]
    np.testing.assert_array_equal(om[:, :2], [[1.0, 0.01], [2.0, 0.02]])
    np.testing.assert_allclose(om, oj, atol=1e-9, rtol=0)
    np.testing.assert_allclose(sm, sj, atol=1e-9, rtol=0)
    np.testing.assert_allclose(xm, xj, atol=1e-9, rtol=0)
    assert xm[2] > 0.1  # the commanded thrust lifts the quad


@pytest.mark.slow
def test_quad_two_node_closed_loop_with_drops():
    """The JAX package's two-node scenario on the plain backend: plant node,
    controller node and reference publisher over the bridge, drops every
    17th odometry message, the busy handshake releasing the publisher."""
    base = BASE + 30
    from ad_mpc_tpu_torch.control.mpc import QuadMPC, quad_spec

    mission = QuadMissionNode(mpc=QuadMPC(spec=quad_spec(qp_iters=10), device="cpu"),
                              control_period=0.01)
    node = ctrl.QuadControllerNode(mission=mission, state_port=base,
                                   control_port=base + 1, reference_port=base + 2,
                                   busy_port=base + 3)
    sim = ctrl.QuadSimNode(rate_hz=100.0, state_port=base, control_port=base + 1,
                           drop_every=17)
    pub = trp.ReferencePublisherNode(generator=trp.ReferenceGenerator(mode="hover"),
                                     reference_port=base + 2, busy_port=base + 3)
    mission.step(sim.x.numpy(), 0.0, seq=0)
    mission._last_seq, mission._optimize_next, mission._msg_count = None, True, 0
    t_ctrl = threading.Thread(target=node.run, kwargs={"max_ticks": 500})
    # 40 s of plant time, where the card's loop needs 6: a plain solve takes
    # a few tenths of a second on the CPU, beside the plant's thread.
    t_sim = threading.Thread(target=sim.run, kwargs={"max_ticks": 4000, "warmup": False})
    try:
        t_ctrl.start()
        t_sim.start()
        sent = pub.run(max_trajectories=1, timeout_s=30.0)
        t_sim.join(timeout=180)
    finally:
        node.stop()
        t_ctrl.join(timeout=60)
        node.close()
        sim.close()
        pub.close()
    assert not t_sim.is_alive() and not t_ctrl.is_alive()
    assert sent == 1
    assert node.n_steps > 50
    assert mission.n_skipped > 0
    # At a few solves a second the 100 Hz plant is not held once airborne
    # and may leave the finite range; the lift-off is read before that
    # (chip_smoke.py phase 21 flies the scenario at the card's rate).
    z = np.stack(sim.states)[:, 2]
    assert float(z[np.isfinite(z)].max()) > 0.6
