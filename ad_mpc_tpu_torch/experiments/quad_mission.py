"""The quadrotor mission in one process: :class:`QuadMissionNode` (its MPC
on ``device``, the card by default) against the host plant
(``sim/simulator.py:QuadrotorSim``), through hover -> ascend -> track ->
land -> off.

    python -m ad_mpc_tpu_torch.experiments.quad_mission [--traj loop] [--v 8]
        [--hover-steps 50] [--qp-iters 18] [--device cuda]

``--traj straight`` is the JAX package's mission test (2 m at 1 m/s from the
trajectory's start, ``tests/test_quad_mission.py``); ``loop`` and
``lemniscate`` come from :class:`ReferenceGenerator` at ``--v``, the flight
starting on the ground at the origin. Prints the phases seen, the tracking
RMSE, the solve time per optimized message (the host clock, the copies to
the card and the fetch included; and of the whole message, with the
recording's host-side
nominal prediction) and the kernels' launches.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ad_mpc_tpu_torch.nodes.quad_node import MissionPhase, QuadMissionNode
from ad_mpc_tpu_torch.sim.simulator import DisturbanceConfig, QuadrotorSim


@dataclass
class MissionResult:
    phases: list  # the phase after each message, the first before any
    x_final: np.ndarray
    n_steps: int
    solve_ms: list = field(default_factory=list)  # each solve, with its copies
    step_ms: list = field(default_factory=list)  # each optimized message, whole

    @property
    def seen(self) -> set:
        return {p.value for p in self.phases}


def ground_start() -> np.ndarray:
    """At rest 0.1 m above the origin, level (``QuadSimNode``'s start)."""
    x = np.zeros(13)
    x[2] = 0.1
    x[3] = 1.0
    return x


def run_mission(node: QuadMissionNode, traj, t_ref, u_traj, x0, hover_steps: int = 0,
                max_steps: int = 4000, sim: QuadrotorSim | None = None) -> MissionResult:
    """Fly the mission: ``hover_steps`` messages of provisional hover, then
    the reference is loaded and the node steps until it is OFF or
    ``max_steps`` messages have gone; one plant step of the node's control
    period per message, without disturbance."""
    sim = sim if sim is not None else QuadrotorSim(disturbances=DisturbanceConfig())
    dt = node.control_period
    x = torch.as_tensor(np.asarray(x0, np.float64))
    t = 0.0
    phases, step_ms = [node.phase], []
    n_solves = len(node.solve_s)
    steps = 0
    for steps in range(1, max_steps + 1):
        if steps - 1 == hover_steps:
            node.receive_trajectory(traj, t_ref, u_traj)
            phases[-1] = node.phase
        n0 = node.n_optimized
        tic = time.perf_counter()
        u = node.step(x.numpy(), t)
        if node.n_optimized > n0:
            step_ms.append(1e3 * (time.perf_counter() - tic))
        x = sim.step(x, u, dt)
        t += dt
        phases.append(node.phase)
        if node.phase == MissionPhase.OFF:
            break
    return MissionResult(phases=phases, x_final=x.numpy(), n_steps=steps,
                         solve_ms=[1e3 * v for v in node.solve_s[n_solves:]],
                         step_ms=step_ms)


def straight_mission():
    """The JAX mission test's reference (2 m at 1 m/s at z = 1) and start."""
    from ad_mpc_tpu_torch.trajectories import straight_trajectory

    traj, t_ref, u_traj = straight_trajectory(
        start=np.array([0.0, 0.0, 1.0]), end=np.array([2.0, 0.0, 1.0]), speed=1.0)
    x0 = np.array(traj[0])
    x0[2] = 1.0
    return (traj, t_ref, u_traj), x0


def main(argv=None):
    import argparse

    from ad_mpc_tpu_torch.control.mpc import QuadMPC, quad_spec
    from ad_mpc_tpu_torch.nodes.reference_publisher import ReferenceGenerator

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traj", default="loop",
                    choices=["straight", "loop", "lemniscate", "hover"])
    ap.add_argument("--v", type=float, default=8.0)
    ap.add_argument("--hover-steps", type=int, default=50)
    ap.add_argument("--qp-iters", type=int, default=18)
    ap.add_argument("--max-steps", type=int, default=4000)
    ap.add_argument("--device", default="cuda",
                    help="the MPC's device; cpu runs the plain versions")
    args = ap.parse_args(argv)

    if args.traj == "straight":
        ref, x0 = straight_mission()
        hover = 0
    else:
        ref = ReferenceGenerator(mode=args.traj, velocities=(args.v,)).next_trajectory()
        x0, hover = ground_start(), args.hover_steps
    mpc = QuadMPC(spec=quad_spec(qp_iters=args.qp_iters), device=args.device)
    node = QuadMissionNode(mpc=mpc, record=True)
    res = run_mission(node, *ref, x0, hover_steps=hover, max_steps=args.max_steps)
    s = mpc.solver
    ms = np.asarray(res.solve_ms[2:])  # the first two build and warm up
    step = np.asarray(res.step_ms[2:])
    print(f"phases {sorted(res.seen)}, final {node.phase.value} at z="
          f"{res.x_final[2]:.3f} m after {res.n_steps} messages, tracking RMSE "
          f"{node.tracking_rmse():.4f} m, {node.n_optimized} solves, solve p50 "
          f"{np.percentile(ms, 50):.3f} ms p99 {np.percentile(ms, 99):.3f} ms, "
          f"message p50 {np.percentile(step, 50):.3f} ms, "
          f"launches vde {s.vde.launches} lq_ipm {s.qp.launches} rk4 {s.rk4.launches}")


if __name__ == "__main__":
    main()
