"""The quadrotor's controller and plant nodes over the native UDP bridge
(port of ``ad_mpc_tpu/nodes/quad_controller.py``; the transport of the
``gp_mpc_node.py`` deployment).

- odometry in with sequence numbers, so that the mission stepper's
  skipped-message compensation meets real drops (``gp_mpc_node.py:443-492``);
- a busy flag answering :class:`ReferencePublisherNode`'s handshake
  (``/is_mpc_busy``): busy while a received trajectory is flown (ascend,
  track, land), not busy when idle;
- the body-rate ControlCommand out (``create_ros_gp_mpc.py:121-143``), which
  the plant node decodes, applying its rotor thrusts.

The controller's mission solves on its MPC's device (the card by default);
the plant is the host simulator.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ad_mpc_tpu_torch.models.quadrotor import QuadrotorParams, hover_input
from ad_mpc_tpu_torch.nodes import topics
from ad_mpc_tpu_torch.nodes.quad_node import MissionPhase, QuadMissionNode
from ad_mpc_tpu_torch.nodes.quad_wrapper import encode_control_command, to_control_command
from ad_mpc_tpu_torch.nodes.reference_publisher import decode_reference
from ad_mpc_tpu_torch.runtime import Publisher, RateTimer, SpscQueue, Subscriber
from ad_mpc_tpu_torch.sim.simulator import DisturbanceConfig, QuadrotorSim


class QuadControllerNode:
    """Transport wrapper over :class:`QuadMissionNode` (by default one on
    ``device``)."""

    def __init__(self, mission: QuadMissionNode | None = None,
                 params: QuadrotorParams = QuadrotorParams(),
                 state_port: int = topics.QUAD_STATE_PORT,
                 control_port: int = topics.QUAD_CONTROL_PORT,
                 reference_port: int = topics.REFERENCE_PORT,
                 busy_port: int = topics.BUSY_PORT, device="cuda"):
        self.mission = mission if mission is not None else QuadMissionNode(
            device=device)
        self.params = params
        self.state_q = SpscQueue(slot_size=512, n_slots=64)
        self.ref_q = SpscQueue(slot_size=4 * 1024 * 1024, n_slots=2)
        self.state_sub = Subscriber(state_port)
        self.ref_sub = Subscriber(reference_port)
        self.control_pub = Publisher(control_port)
        self.busy_pub = Publisher(busy_port)
        self._stop = threading.Event()
        self._rx_threads: list[threading.Thread] = []
        self.n_steps = 0

    def _rx_loop(self, sub: Subscriber, q: SpscQueue):
        while not self._stop.is_set():
            msg = sub.receive(timeout_ms=50)
            if msg is not None:
                q.push(*msg)

    def start_io(self):
        for sub, q in ((self.state_sub, self.state_q), (self.ref_sub, self.ref_q)):
            t = threading.Thread(target=self._rx_loop, args=(sub, q), daemon=True)
            t.start()
            self._rx_threads.append(t)

    @property
    def busy(self) -> bool:
        return self.mission.phase in (MissionPhase.ASCEND, MissionPhase.TRACK,
                                      MissionPhase.LAND)

    def handle_state(self, msg: np.ndarray) -> np.ndarray:
        """One odometry message [seq, t, x13] -> an encoded ControlCommand."""
        seq = int(msg[0])
        t = float(msg[1])
        x = np.array(msg[2:15], np.float64)
        u = self.mission.step(x, t, seq=seq)
        self.n_steps += 1
        xs = self.mission.last_xs
        if xs is None:
            xs = np.tile(x, (2, 1))
        cmd = to_control_command(np.atleast_2d(u), xs, self.params, t=t,
                                 armed=self.mission.phase != MissionPhase.OFF)
        return encode_control_command(cmd)

    def run(self, max_ticks: int | None = None):
        self.start_io()
        ticks = 0
        while not self._stop.is_set():
            if max_ticks is not None and ticks >= max_ticks:
                break
            ref_msg = self.ref_q.pop_latest()
            if ref_msg is not None:
                self.mission.receive_trajectory(*decode_reference(ref_msg[1]))
            st = self.state_q.pop_latest()
            if st is not None:
                out = self.handle_state(np.asarray(st[1], np.float64))
                self.control_pub.publish(topics.TAG_QUAD_CONTROL, out)
                ticks += 1
            self.busy_pub.publish(topics.TAG_BUSY, np.array([self.busy], np.uint8))
            if st is None:
                time.sleep(0.002)

    def stop(self):
        self._stop.set()

    def close(self):
        """Stop, let the I/O threads see it, and release the sockets."""
        self.stop()
        for t in self._rx_threads:
            t.join(timeout=2.0)
        for s in (self.state_sub, self.ref_sub, self.control_pub, self.busy_pub):
            s.close()


class QuadSimNode:
    """Quadrotor plant node (the Gazebo/RotorS role): publishes sequenced
    odometry [seq, t, x13] and applies the rotor thrusts of the commands it
    receives to the host :class:`QuadrotorSim`. ``drop_every``: drop every
    n-th odometry message, for the controller's skipped-message
    compensation. ``seed`` seeds the plant's ``torch.Generator``."""

    def __init__(self, rate_hz: float = 100.0,
                 params: QuadrotorParams = QuadrotorParams(), seed: int = 0,
                 state_port: int = topics.QUAD_STATE_PORT,
                 control_port: int = topics.QUAD_CONTROL_PORT,
                 drop_every: int | None = None):
        self.params = params
        self.rate_hz = rate_hz
        self.dt = 1.0 / rate_hz
        self.sim = QuadrotorSim(params=params, disturbances=DisturbanceConfig(),
                                seed=seed)
        x0 = np.zeros(13)
        x0[2] = 0.1
        x0[3] = 1.0
        self.x = torch.as_tensor(x0)
        self.u_thrust = np.asarray(hover_input(params)) * params.max_thrust
        self.state_pub = Publisher(state_port)
        self.control_sub = Subscriber(control_port)
        self.timer = RateTimer(rate_hz)
        self.seq = 0
        self.t = 0.0
        self.drop_every = drop_every
        self.states: list[np.ndarray] = []

    def tick(self):
        self.seq += 1
        self.t += self.dt
        xi = self.x.numpy().copy()
        self.states.append(xi)
        dropped = self.drop_every is not None and self.seq % self.drop_every == 0
        if not dropped:
            msg = np.concatenate([[float(self.seq), self.t], xi])
            self.state_pub.publish(topics.TAG_QUAD_STATE, msg.astype(np.float64))
        while True:
            m = self.control_sub.receive(timeout_ms=0)
            if m is None:
                break
            self.u_thrust = np.asarray(m[1], np.float64)[7:11]  # rotor thrusts [N]
        u_norm = np.clip(self.u_thrust / self.params.max_thrust, 0.0, 1.0)
        self.x = self.sim.step(self.x, u_norm, self.dt)

    def warmup(self):
        """One plant step, discarded, before the real-time loop."""
        self.sim.step(self.x, np.full(4, 0.5), self.dt)

    def run(self, max_ticks: int | None = None, warmup: bool = True):
        if warmup:
            self.warmup()
        ticks = 0
        while max_ticks is None or ticks < max_ticks:
            self.timer.sleep()
            self.tick()
            ticks += 1

    def close(self):
        for s in (self.state_pub, self.control_sub):
            s.close()
