"""Plant-simulator node: the CARLA-bridge role in the reference stack (port
of ``ad_mpc_tpu/nodes/sim_node.py``).

Publishes the vehicle state at a fixed rate, applies received control
commands to the bicycle plant (``sim/simulator.py``, on the host), and
publishes the waypoint window of a global track (the ``/local_traj``
producer role).
"""

from __future__ import annotations

import numpy as np
import torch

from ad_mpc_tpu_torch.experiments.ad_closed_loop import oval_track, track_rmse
from ad_mpc_tpu_torch.nodes import topics
from ad_mpc_tpu_torch.runtime import Publisher, RateTimer, Subscriber
from ad_mpc_tpu_torch.sim.simulator import BicycleSim, DisturbanceConfig


class SimNode:
    def __init__(
        self,
        rate_hz: float = 50.0,
        v_target: float = 8.0,
        disturbances: DisturbanceConfig = DisturbanceConfig(),
        seed: int = 0,
        state_port: int = topics.STATE_PORT,
        control_port: int = topics.CONTROL_PORT,
        waypoint_port: int = topics.WAYPOINT_PORT,
        device="cpu",
        track_radius: float = 30.0,
    ):
        """``device``: where the plant's state lives; the CPU, as the
        deployment loop pins the 50 Hz plant to the host while the
        controller's solver runs on the card in the same process.
        ``track_radius``: the oval's corner radius; shrink it (with a high
        ``v_target``) for aggressive scenarios where actuation lag bites."""
        self.rate_hz = rate_hz
        self.dt = 1.0 / rate_hz
        self.sim = BicycleSim(disturbances=disturbances, seed=seed, device=device)
        self.x = torch.zeros(7, dtype=torch.float64, device=device)
        self.x[3] = v_target * 0.5
        self.u = np.zeros(2)
        self.v_target = v_target
        self.track = oval_track(r=track_radius)

        self.state_pub = Publisher(state_port)
        self.wp_pub = Publisher(waypoint_port)
        self.control_sub = Subscriber(control_port)
        self.timer = RateTimer(rate_hz)
        self.states = []

    def tick(self):
        tx, ty, tpsi = self.track
        xi = self.x.cpu().numpy()

        # Publish the waypoint window ahead of the vehicle (/local_traj).
        m = len(tx)
        ci = int(np.argmin((tx - xi[0]) ** 2 + (ty - xi[1]) ** 2))
        idx = (ci + np.arange(0, 200)) % m
        wps = np.stack(
            [tx[idx], ty[idx], tpsi[idx], np.full(len(idx), self.v_target)],
            axis=1,
        ).astype(np.float32)
        self.wp_pub.publish(topics.TAG_WAYPOINTS, wps)

        # Publish the state.
        self.state_pub.publish(topics.TAG_STATE, xi.astype(np.float32))

        # Apply the most recent control (drain the socket).
        while True:
            msg = self.control_sub.receive(timeout_ms=0)
            if msg is None:
                break
            _, cmd = msg
            self.u = np.asarray(cmd[:2], np.float64)

        self.x = self.sim.step(self.x, self.u, self.dt)
        self.states.append(xi)

    def warmup(self):
        """One plant step, discarded, before the real-time loop."""
        self.sim.step(self.x, self.u, self.dt)

    def run(self, max_ticks: int | None = None, warmup: bool = True):
        if warmup:
            self.warmup()
        ticks = 0
        while max_ticks is None or ticks < max_ticks:
            self.timer.sleep()
            self.tick()
            ticks += 1

    def tracking_rmse(self) -> float:
        return track_rmse(np.stack(self.states), self.track)

    def close(self):
        for s in (self.state_pub, self.wp_pub, self.control_sub):
            s.close()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rate", type=float, default=50.0)
    ap.add_argument("--v", type=float, default=8.0)
    ap.add_argument("--ticks", type=int, default=None)
    ap.add_argument("--noisy", action="store_true")
    ap.add_argument(
        "--base-port", type=int, default=None,
        help="use ports base, base+1, base+2 for state/control/waypoints "
        "(foreign-process wiring; default: the topics.py well-known ports)",
    )
    args = ap.parse_args(argv)

    ports = {}
    if args.base_port is not None:
        ports = dict(state_port=args.base_port, control_port=args.base_port + 1,
                     waypoint_port=args.base_port + 2)
    node = SimNode(rate_hz=args.rate, v_target=args.v,
                   disturbances=DisturbanceConfig(noisy=args.noisy), **ports)
    try:
        node.run(max_ticks=args.ticks)
    finally:
        node.close()
        print(f"sim RMSE vs track: {node.tracking_rmse():.4f} m, "
              f"jitter: {node.timer.jitter_stats()}")


if __name__ == "__main__":
    main()
