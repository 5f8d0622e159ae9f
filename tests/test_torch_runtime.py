"""The port's native runtime bridge and node layer: the non-slow cases of
``tests/test_runtime.py`` on ``ad_mpc_tpu_torch.runtime`` (SPSC queue, UDP
pub/sub, rate timer), its messages read by the JAX package's bridge, the
library built under ``build/``, the safety shell's brake streak
(``tests/test_safety.py:test_unsafe_streak_continuously_brakes_plant``)
and a short in-process two-node loop on the plain backend.

Ports 48331-48332, 48750-48753 and 49620-49667: none of the JAX tests' or
``topics.py``'s,
since the test files run side by side.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ad_mpc_tpu.nodes import topics as jax_topics
from ad_mpc_tpu.runtime import bridge as jax_bridge
from ad_mpc_tpu_torch.nodes import topics
from ad_mpc_tpu_torch.runtime import (
    Publisher,
    RateTimer,
    SpscQueue,
    Subscriber,
    bridge,
    monotonic_ns,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain path's small operations run fastest on one thread, and the
    test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestSpsc:
    def test_round_trip(self):
        q = SpscQueue(slot_size=1024, n_slots=8)
        arr = np.arange(12, dtype=np.float32).reshape(3, 4)
        assert q.push(7, arr)
        tag, out = q.pop()
        assert tag == 7
        np.testing.assert_array_equal(out, arr)
        assert q.pop() is None

    def test_pop_latest_discards(self):
        q = SpscQueue(slot_size=256, n_slots=16)
        for i in range(5):
            q.push(1, np.array([i], dtype=np.int64))
        tag, out = q.pop_latest()
        assert int(out[0]) == 4
        assert len(q) == 0

    def test_full_queue(self):
        q = SpscQueue(slot_size=128, n_slots=2)
        a = np.zeros(4, np.float32)
        assert q.push(0, a)
        assert q.push(0, a)
        assert not q.push(0, a)  # full

    def test_threaded_producer_consumer(self):
        q = SpscQueue(slot_size=256, n_slots=64)
        n = 2000
        received = []

        def producer():
            i = 0
            while i < n:
                if q.push(0, np.array([i], dtype=np.int64)):
                    i += 1

        def consumer():
            while len(received) < n:
                msg = q.pop()
                if msg is not None:
                    received.append(int(msg[1][0]))

        tp = threading.Thread(target=producer)
        tc = threading.Thread(target=consumer)
        tp.start(); tc.start()
        tp.join(timeout=20); tc.join(timeout=20)
        assert received == list(range(n))  # FIFO order, no loss, no dupes


class TestUdp:
    def test_pub_sub_round_trip(self):
        port = 48331
        sub = Subscriber(port)
        pub = Publisher(port)
        arr = np.random.default_rng(0).normal(size=(10, 7)).astype(np.float32)
        pub.publish(3, arr)
        msg = sub.receive(timeout_ms=1000)
        assert msg is not None
        tag, out = msg
        assert tag == 3
        np.testing.assert_array_equal(out, arr)
        pub.close(); sub.close()

    def test_timeout_returns_none(self):
        sub = Subscriber(48332)
        t0 = time.time()
        assert sub.receive(timeout_ms=50) is None
        assert time.time() - t0 < 1.0
        sub.close()


class TestRate:
    def test_period_accuracy(self):
        timer = RateTimer(200.0)  # 5 ms period
        t0 = monotonic_ns()
        for _ in range(20):
            timer.sleep()
        elapsed = (monotonic_ns() - t0) / 1e9
        assert 0.08 < elapsed < 0.25  # ~0.1 s nominal, generous upper bound
        stats = timer.jitter_stats()
        assert stats["p50_ms"] < 5.0


def test_messages_and_topics_match_the_jax_package():
    """Both bridges speak one wire format, so a node of either package can
    talk to a node of the other; the topic map is the same."""
    for arr in (np.arange(6, dtype=np.float32).reshape(2, 3),
                np.array([1], np.uint8), np.zeros((4, 200), np.float64)):
        data = bridge.encode(5, arr)
        assert data == jax_bridge.encode(5, arr)
        tag, out = jax_bridge.decode(data)
        assert tag == 5
        np.testing.assert_array_equal(out, arr)
    names = [n for n in dir(jax_topics) if n.isupper()]
    assert [getattr(topics, n) for n in names] == [getattr(jax_topics, n) for n in names]


def test_library_builds_under_build_not_beside_its_source():
    bridge.get_lib()
    so = bridge.library_path()
    assert so.exists() and so.parent == bridge.BUILD_DIR
    assert os.path.commonpath([str(so), REPO]) == REPO
    assert not list(bridge.SRC.parent.glob("*.so"))


def test_unsafe_streak_continuously_brakes_plant():
    """While unarmed the node publishes brake and hold on every tick, so the
    plant decelerates through an unsafe streak instead of coasting."""
    from ad_mpc_tpu_torch.nodes.ad_node import ADControllerNode
    from ad_mpc_tpu_torch.sim.simulator import BicycleSim

    node = ADControllerNode(
        rate_hz=50.0, n_nodes=8, t_horizon=0.4, qp_iters=4,
        arming_threshold=10**9, state_port=49640, control_port=49641,
        waypoint_port=49642, status_port=49643, device="cpu",
    )
    try:
        n = 80
        node.ref_gen.set_traj(np.linspace(0.0, 80.0, n), np.zeros(n),
                              np.zeros(n), np.full(n, 8.0))
        sim = BicycleSim()
        x = np.zeros(7)
        x[3] = 8.0
        v0 = x[3]
        for _ in range(25):
            cmd = node.control_tick(x)
            assert cmd is not None, "unsafe tick must still publish a command"
            assert cmd[0] < -9.0, "unsafe command must brake"
            x = sim.step(torch.as_tensor(x), cmd[:2], 0.02).numpy()
        assert x[3] < v0 - 3.0, f"plant did not decelerate: v={x[3]:.2f}"
    finally:
        node.close()


@pytest.mark.parametrize("pipelined", [False, True])
def test_deployment_loop_on_the_plain_backend(pipelined):
    """The two-node stack in one process for 60 ticks at 50 Hz, the solver
    on the CPU's plain versions (a tick there takes longer than the period:
    the controller ticks as fast as it can while the plant keeps time). The
    loop closes, the car tracks the oval, and no kernel launches; the
    result carries the JAX package's keys."""
    from ad_mpc_tpu_torch.experiments.deployment_loop import run_deployment_loop

    d = run_deployment_loop(ticks=60, n_nodes=10, v_target=6.0, device="cpu",
                            pipelined=pipelined, base_port=49620 + 8 * pipelined)
    keys = {"ticks", "rate_hz", "budget_ms", "pipelined", "lag_compensation",
            "v_target", "track_radius", "wall_s", "solver_platform",
            "tick_p50_ms", "tick_p99_ms", "missed_deadlines",
            "scheduler_jitter", "n_solves", "n_unsafe_ticks",
            "tracking_rmse_m", "host_link_floor_p50_ms", "tick_p50_minus_link_ms"}
    assert keys <= set(d)
    assert d["solver_platform"] == "cpu"
    assert d["n_solves"] == d["ticks"] >= 30
    assert d["tracking_rmse_m"] < 1.0
    assert d["launches"] == {"vde": 0, "lq_ipm": 0, "rk4": 0}
    if pipelined:
        assert d["result_age_max_ticks"] >= d["result_age_p50_ticks"] >= 1


@pytest.mark.parametrize("delay", [0, 1, 2])
def test_result_delay_sets_the_published_age(delay):
    """Pipelined, each result is back within its tick here: published one
    tick after its solve, or 1 + ``result_delay_ticks`` with the delay."""
    from ad_mpc_tpu_torch.nodes.ad_node import ADControllerNode

    node = ADControllerNode(
        rate_hz=50.0, n_nodes=8, t_horizon=0.4, qp_iters=4, pipelined=True,
        lag_compensation=False, result_delay_ticks=delay, state_port=48750,
        control_port=48751, waypoint_port=48752, status_port=48753, device="cpu")
    try:
        n = 80
        node.ref_gen.set_traj(np.linspace(0.0, 80.0, n), np.zeros(n),
                              np.zeros(n), np.full(n, 8.0))
        x = np.zeros(7)
        x[3] = 8.0
        for _ in range(8):
            node.control_tick(x)
            for _ in range(100):  # let the fetch thread take the result
                if node._done and node._done[-1][0] == node.n_solves:
                    break
                time.sleep(0.01)
    finally:
        node.close()
    assert node.result_age == [1 + delay] * (8 - 1 - delay)
    with pytest.raises(ValueError, match="only pipelined"):
        ADControllerNode(result_delay_ticks=1, device="cpu")


@pytest.mark.slow
def test_two_process_closed_loop():
    """The plant as a separate OS process (``python -m
    ad_mpc_tpu_torch.nodes.sim_node``) speaking only the UDP codec, the
    controller on the plain backend in this one."""
    import re
    import subprocess

    from ad_mpc_tpu_torch.nodes.ad_node import ADControllerNode

    base = 49660
    ctrl = ADControllerNode(
        rate_hz=50.0, n_nodes=10, t_horizon=0.5, arming_threshold=2,
        qp_iters=8, state_port=base, control_port=base + 1,
        waypoint_port=base + 2, status_port=base + 3, device="cpu",
    )
    ctrl.warmup()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ad_mpc_tpu_torch.nodes.sim_node",
         "--ticks", "160", "--v", "6.0", "--base-port", str(base)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
    t_ctrl = threading.Thread(target=ctrl.run,
                              kwargs={"max_ticks": None, "warmup": False})
    t_ctrl.start()
    try:
        out, _ = proc.communicate(timeout=120)
    finally:
        ctrl.stop()
        t_ctrl.join(timeout=30)
        ctrl.close()
    assert proc.returncode == 0, out[-800:]
    assert ctrl.n_solves > 5, "controller never heard the foreign process"
    m = re.search(r"sim RMSE vs track: ([0-9.]+) m", out)
    assert m and float(m.group(1)) < 1.0, out[-800:]
