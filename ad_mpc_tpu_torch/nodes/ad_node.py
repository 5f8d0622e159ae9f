"""AD closed-loop controller node (port of ``ad_mpc_tpu/nodes/ad_node.py``).

A standalone process that
- subscribes to vehicle state and waypoint lists over the native UDP bridge;
- hands states to the control loop through a wait-free SPSC queue with
  latest-wins semantics;
- runs the SQP-RTI MPC at a fixed rate with deadline tracking;
- applies the full safety shell: solver-health watchdog with arming
  counter, predicted-trajectory check, shifted-backup control, and a brake
  fallback when unsafe;
- publishes control and a busy/healthy heartbeat.

The solver runs on ``device`` (the card by default). The reference
windowing and the lag-compensation predictor run on the host CPU by
design, as in the JAX node: their outputs are consumed by numpy at once.
Each tick copies the packed state and reference to the card once and
fetches the 4-float result once; nothing else waits for the card.
"""

from __future__ import annotations

import collections
import queue
import threading
import time

import numpy as np
import torch

from ad_mpc_tpu_torch.control import safety
from ad_mpc_tpu_torch.control.mpc import BicycleMPC, bicycle_spec
from ad_mpc_tpu_torch.control.reference import PathReference
from ad_mpc_tpu_torch.models.bicycle import BicycleParams, bicycle_dynamics
from ad_mpc_tpu_torch.nodes import topics
from ad_mpc_tpu_torch.ops.integrators import rk4_step_floats
from ad_mpc_tpu_torch.runtime import (
    Publisher,
    RateTimer,
    SpscQueue,
    Subscriber,
    monotonic_ns,
)

BRAKE = np.array([-1e5, 0.0], np.float32)  # the fallback's [accel, steer_rate]


def one_period_predictor(rate_hz: float, params: BicycleParams = BicycleParams()):
    """The lag-compensation plant model on the host: x, u -> the state one
    control period ahead (two RK4 steps of the bicycle with its own blend
    switch), in Python floats."""
    h = 0.5 / rate_hz
    f = lambda xx, uu: bicycle_dynamics(xx, uu, params)

    def predict(x, u):
        xx, uu = [float(v) for v in x], [float(v) for v in u]
        for _ in range(2):
            xx = rk4_step_floats(f, xx, uu, h)
        return np.asarray(xx, np.float64)

    return predict


class ADControllerNode:
    def __init__(
        self,
        rate_hz: float = 50.0,
        n_nodes: int = 20,
        t_horizon: float = 1.0,
        arming_threshold: int = 10,
        qp_iters: int = 10,
        state_port: int = topics.STATE_PORT,
        control_port: int = topics.CONTROL_PORT,
        waypoint_port: int = topics.WAYPOINT_PORT,
        status_port: int = topics.STATUS_PORT,
        pipelined: bool = False,
        lag_compensation: bool = True,
        result_delay_ticks: int = 0,
        device="cuda",
        backend: str = "auto",
    ):
        """``pipelined=True`` decouples the control loop from the link to
        the card: each tick launches the fused solve and publishes the most
        recent completed command, while a background thread waits for each
        result (a copy into pinned host memory behind a CUDA event).
        Actuation lags by one pipeline slot, but the loop itself never
        waits for the card.

        ``lag_compensation`` (pipelined mode only): the command computed
        from this tick's state is actuated one control period later, so the
        solve is anchored at the state forward-predicted one period through
        the plant model under the command the node published last.

        ``result_delay_ticks`` (pipelined mode only) holds each completed
        result back: the result of the solve launched on tick k is
        published no earlier than tick k + 1 + ``result_delay_ticks``. It
        emulates the link to the device that the JAX package's deployment
        rows ran behind (``BENCH_DETAIL.json``: ``host_link_floor_p50_ms``
        23.8-24.7 ms over a 20 ms period, so that their commands were two
        ticks old at p50; here 1 gives that age). It is no capability of
        the controller; at 0 the node publishes the newest completed
        result, as without it."""
        if result_delay_ticks < 0 or (result_delay_ticks and not pipelined):
            raise ValueError("result_delay_ticks >= 0, and > 0 only pipelined")
        spec = bicycle_spec(t_horizon=t_horizon, n_nodes=n_nodes,
                            qp_iters=qp_iters)
        self.mpc = BicycleMPC(spec=spec, device=device, backend=backend)
        self.spec = spec
        self.device = torch.device(device)
        self.rate_hz = rate_hz
        self.ref_gen = PathReference(traj_horizon=n_nodes + 1, traj_dt=spec.dt)
        self.gate = safety.ArmingGate(arming_threshold)

        self.state_q = SpscQueue(slot_size=512, n_slots=32)
        self.wp_q = SpscQueue(slot_size=65536, n_slots=4)
        self.state_sub = Subscriber(state_port)
        self.wp_sub = Subscriber(waypoint_port)
        self.control_pub = Publisher(control_port)
        self.status_pub = Publisher(status_port)

        self._stop = threading.Event()
        self._rx_threads = []
        self.n_solves = 0
        self.n_unsafe = 0
        self.timer = RateTimer(rate_hz)
        # Per-tick control wall time [s] against the 20 ms control period.
        self.tick_wall = []
        # Pipelined mode: per published MPC command, the ticks since the
        # solve that computed it (1: the previous tick's).
        self.result_age = []
        # The fused controller step and its device-resident carry (warm
        # start, previous plan, have-previous flag).
        self._fused = self.mpc.make_fused_step()
        self._carry = None
        self.pipelined = pipelined
        self.lag_compensation = lag_compensation
        self.result_delay_ticks = result_delay_ticks
        self._fetch_q = None
        # The completed results (solve number, output), oldest first.
        self._done = collections.deque(maxlen=16)
        self._done_lock = threading.Lock()
        self._predict = None
        # [accel, steer_rate] the node actually returned last tick (MPC
        # command or brake fallback): the lag-compensation plant input.
        self._last_pub_u = None
        if pipelined:
            self._fetch_q = queue.Queue(maxsize=8)
            t = threading.Thread(target=self._fetch_loop, daemon=True)
            t.start()
            self._rx_threads.append(t)
            if lag_compensation:
                self._predict = one_period_predictor(rate_hz, self.mpc.params)

    # ---------------------------------------------------------- I/O threads

    def _rx_loop(self, sub: Subscriber, q: SpscQueue):
        while not self._stop.is_set():
            msg = sub.receive(timeout_ms=50)
            if msg is not None:
                q.push(*msg)

    def _fetch_loop(self):
        """Wait for each launched result off the control loop's critical
        path and keep the newest."""
        while not self._stop.is_set():
            try:
                solve, host, done = self._fetch_q.get(timeout=0.1)
            except queue.Empty:
                continue
            if done is not None:
                done.synchronize()
            out_np = host.numpy().copy()
            with self._done_lock:
                self._done.append((solve, out_np))

    def start_io(self):
        for sub, q in ((self.state_sub, self.state_q),
                       (self.wp_sub, self.wp_q)):
            t = threading.Thread(target=self._rx_loop, args=(sub, q),
                                 daemon=True)
            t.start()
            self._rx_threads.append(t)

    # ----------------------------------------------------------- card I/O

    def _to_device(self, packed: np.ndarray) -> torch.Tensor:
        """The tick's one host-to-device copy, from pinned memory."""
        t = torch.from_numpy(packed)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _launch_fetch(self, out: torch.Tensor):
        """(host tensor, CUDA event): a copy of ``out`` into pinned memory,
        complete once the event is."""
        if self.device.type != "cuda":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    # ----------------------------------------------------------- control loop

    def control_tick(self, x: np.ndarray) -> np.ndarray | None:
        """One MPC tick for state x; returns the control message
        [accel, steer_rate, steer_cmd] (brake fallback while unarmed)."""
        out_np = None
        if self.pipelined:
            # The newest COMPLETED result is the command published this
            # tick (one-slot actuation pipeline).
            # The newest completed result old enough to publish: of a solve
            # at least 1 + result_delay_ticks ticks back.
            newest = self.n_solves - self.result_delay_ticks
            with self._done_lock:
                latest = next((d for d in reversed(self._done) if d[0] <= newest),
                              None)
            if latest is not None:
                solve, out_np = latest
                self.result_age.append(self.n_solves + 1 - solve)
            if self._predict is not None and self._last_pub_u is not None:
                # Anchor this tick's solve at the state one control period
                # ahead under the command the node published last tick (the
                # MPC command when armed, the brake when not), with the
                # plant's actuator semantics: clipped inputs, braking stops
                # at standstill.
                p = self.mpc.params
                u_act = np.array([
                    np.clip(self._last_pub_u[0], p.acc_min, p.acc_max),
                    np.clip(self._last_pub_u[1], p.steering_rate_min,
                            p.steering_rate_max),
                ], np.float32)
                x_pred = self._predict(x, u_act)
                if u_act[0] < 0.0:
                    x_pred[3] = max(x_pred[3], 0.0)
                x = x_pred

        # Envelope-capped window on the host: positions AND velocities
        # describe the same reachable trajectory.
        wp = self.ref_gen.get_waypoints_enveloped(x[0], x[1], x[2], x[3])
        n = self.spec.n_nodes
        x_ref = np.zeros((n + 1, 7), np.float32)
        x_ref[:, 0] = wp.x_ref.numpy()
        x_ref[:, 1] = wp.y_ref.numpy()
        x_ref[:, 2] = wp.psi_ref.numpy()
        x_ref[:, 3] = wp.v_ref.numpy()

        packed = np.concatenate([x[None].astype(np.float32), x_ref])
        if self._carry is None:
            self._carry = self.mpc.fused_init(np.asarray(x, np.float32))
        out, *carry = self._fused(self._to_device(packed), *self._carry)
        self._carry = tuple(carry)
        self.n_solves += 1
        if self.pipelined:
            try:
                self._fetch_q.put_nowait((self.n_solves, *self._launch_fetch(out)))
            except queue.Full:
                pass  # fetcher saturated: keep the last result
            if out_np is None:
                self.n_unsafe += 1
                self._last_pub_u = BRAKE
                return np.array([BRAKE[0], BRAKE[1], float(x[6])], np.float32)
        else:
            out_np = out.cpu().numpy()  # the tick's one fetch
        cmd_np, healthy = out_np[:3], bool(out_np[3] > 0.5)

        if not self.gate.update(healthy):
            # While unarmed the fallback controller publishes hold-steering
            # + full braking on every tick: never let the plant coast on
            # its last command.
            self.n_unsafe += 1
            self._last_pub_u = BRAKE
            return np.array([BRAKE[0], BRAKE[1], float(x[6])], np.float32)

        self._last_pub_u = np.asarray(out_np[:2], np.float32)
        return np.asarray(cmd_np, np.float32)

    def warmup(self):
        """Run one tick on a straight path before the real-time loop (the
        kernels' first launches and the allocators' first blocks), then
        reset every piece of state the tick touched."""
        n = 50
        xs = np.linspace(0, 50, n)
        self.ref_gen.set_traj(xs, np.zeros(n), np.zeros(n), np.full(n, 5.0))
        x = np.zeros(7)
        x[3] = 5.0
        self.control_tick(x)
        if self.pipelined:
            # Drain the warm-up result, then clear it so that the real loop
            # starts from a clean pipeline.
            for _ in range(50):
                with self._done_lock:
                    got = bool(self._done)
                if got or self._stop.is_set():
                    break
                time.sleep(0.05)
        self.mpc.reset()
        self._carry = None
        self._last_pub_u = None
        with self._done_lock:
            self._done.clear()
        self.ref_gen._path = None
        self.gate.count = 0
        self.n_solves = 0
        self.n_unsafe = 0
        self.tick_wall = []
        self.result_age = []

    def run(self, max_ticks: int | None = None, warmup: bool = True):
        if warmup:
            self.warmup()
        # Re-anchor the rate timer after the warm-up so that the first real
        # tick does not report it as a deadline overrun.
        self.timer = RateTimer(self.rate_hz)
        self.start_io()
        x = None
        ticks = 0
        while not self._stop.is_set():
            if max_ticks is not None and ticks >= max_ticks:
                break
            self.timer.sleep()
            ticks += 1

            wp_msg = self.wp_q.pop_latest()
            if wp_msg is not None:
                _, w = wp_msg
                self.ref_gen.set_traj(w[:, 0], w[:, 1], w[:, 2], w[:, 3])

            st_msg = self.state_q.pop_latest()
            if st_msg is not None:
                _, x = st_msg
                x = x.astype(np.float64)

            busy = x is not None and self.ref_gen._path is not None
            self.status_pub.publish(topics.TAG_STATUS, np.array([busy], np.uint8))
            if not busy:
                continue

            t0 = monotonic_ns()
            cmd = self.control_tick(x)
            self.tick_wall.append((monotonic_ns() - t0) / 1e9)
            if cmd is not None:
                self.control_pub.publish(topics.TAG_CONTROL, cmd)

    def stop(self):
        self._stop.set()

    def close(self):
        """Stop, let the I/O threads see it, and release the sockets."""
        self.stop()
        for t in self._rx_threads:
            t.join(timeout=2.0)
        for s in (self.state_sub, self.wp_sub, self.control_pub, self.status_pub):
            s.close()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rate", type=float, default=50.0)
    ap.add_argument("--nodes", type=int, default=20)
    ap.add_argument("--ticks", type=int, default=None)
    ap.add_argument("--pipelined", action="store_true")
    ap.add_argument("--result-delay", type=int, default=0,
                    help="pipelined: hold each result this many ticks (the "
                    "emulated link of the JAX package's rows)")
    ap.add_argument("--device", default="cuda",
                    help="the solver's device; cpu runs the plain versions")
    args = ap.parse_args(argv)

    node = ADControllerNode(rate_hz=args.rate, n_nodes=args.nodes,
                            pipelined=args.pipelined,
                            result_delay_ticks=args.result_delay, device=args.device)
    try:
        node.run(max_ticks=args.ticks)
    except KeyboardInterrupt:
        pass
    finally:
        node.close()
        print("jitter:", node.timer.jitter_stats(),
              "solves:", node.n_solves, "unsafe:", node.n_unsafe)


if __name__ == "__main__":
    main()
