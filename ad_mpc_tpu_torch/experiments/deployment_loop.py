"""The deployment loop: the real node path at 50 Hz (port of
``ad_mpc_tpu/experiments/deployment_loop.py``).

Runs the deployment stack: :class:`ADControllerNode` (its solver on
``device``, the card by default) against :class:`SimNode` (the plant pinned
to the host CPU, the CARLA-process role), in two threads of one process
over the native ``rt_bridge`` UDP/SPSC transport, and records per-tick
control wall time, scheduler lateness and missed 20 ms deadlines.

    python -m ad_mpc_tpu_torch.experiments.deployment_loop [--ticks 600]
        [--pipelined] [--no-lag-comp] [--result-delay 0] [--v 8] [--radius 30]
        [--device cuda]
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch


def measure_link_floor(reps: int = 20, device="cuda") -> float:
    """p50 blocking round trip of a trivial op on ``device``: the
    launch-and-synchronize floor under every blocking solve [ms]."""
    device = torch.device(device)
    x = torch.zeros((1, 8), dtype=torch.float32, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    _ = x + 1.0
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _ = x + 1.0
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.percentile(1e3 * np.asarray(ts), 50))


def run_deployment_loop(
    ticks: int = 600,
    rate_hz: float = 50.0,
    n_nodes: int = 20,
    base_port: int = 49500,
    v_target: float = 8.0,
    pipelined: bool = False,
    lag_compensation: bool = True,
    track_radius: float = 30.0,
    result_delay_ticks: int = 0,
    device="cuda",
    backend: str = "auto",
) -> dict:
    """Drive the two-node stack for ``ticks`` control periods; returns the
    JAX package's dict keys, plus ``launches`` (the controller's kernel
    launches in the real-time loop, by kernel) and, pipelined, the age of
    the published commands in ticks (``result_age_p50_ticks``,
    ``result_age_max_ticks``).

    ``pipelined``: the controller's one-slot actuation pipeline (the solve
    launched, its result fetched off the critical path).
    ``lag_compensation`` (pipelined only): anchor each solve at the state
    forward-predicted by the one-slot actuation lag. ``track_radius`` and
    ``v_target`` set the scenario's aggressiveness (lateral acceleration
    about v^2/r). ``result_delay_ticks`` (pipelined only): hold each result
    that many ticks, the emulated link of the JAX package's rows
    (``ADControllerNode``). Ports ``base_port`` .. ``base_port + 3``."""
    from ad_mpc_tpu_torch.nodes.ad_node import ADControllerNode
    from ad_mpc_tpu_torch.nodes.sim_node import SimNode

    ctrl = ADControllerNode(
        rate_hz=rate_hz, n_nodes=n_nodes, t_horizon=n_nodes * 0.05,
        arming_threshold=5,
        state_port=base_port, control_port=base_port + 1,
        waypoint_port=base_port + 2, status_port=base_port + 3,
        pipelined=pipelined, lag_compensation=lag_compensation,
        result_delay_ticks=result_delay_ticks, device=device, backend=backend,
    )
    sim = SimNode(
        rate_hz=rate_hz, v_target=v_target,
        state_port=base_port, control_port=base_port + 1,
        waypoint_port=base_port + 2, device="cpu",
        track_radius=track_radius,
    )
    try:
        ctrl.warmup()
        sim.warmup()
        solver = ctrl.mpc.solver
        solver.vde.launches = solver.qp.launches = solver.rk4.launches = 0

        t_ctrl = threading.Thread(
            target=ctrl.run, kwargs={"max_ticks": ticks, "warmup": False})
        t_sim = threading.Thread(
            target=sim.run, kwargs={"max_ticks": ticks, "warmup": False})
        t0 = time.perf_counter()
        t_ctrl.start()
        t_sim.start()
        t_ctrl.join(timeout=ticks / rate_hz * 10 + 120)
        ctrl.stop()
        t_sim.join(timeout=60)
        wall = time.perf_counter() - t0
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        launches = {"vde": solver.vde.launches, "lq_ipm": solver.qp.launches,
                    "rk4": solver.rk4.launches}
    finally:
        ctrl.close()
        sim.close()

    tick_ms = 1e3 * np.asarray(ctrl.tick_wall)
    budget_ms = 1e3 / rate_hz
    link_ms = measure_link_floor(device=device)
    out = {
        "ticks": int(len(tick_ms)),
        "rate_hz": rate_hz,
        "budget_ms": budget_ms,
        "pipelined": pipelined,
        "lag_compensation": bool(pipelined and lag_compensation),
        "result_delay_ticks": result_delay_ticks,
        "v_target": v_target,
        "track_radius": track_radius,
        "wall_s": round(wall, 1),
        "solver_platform": torch.device(device).type,
        "tick_p50_ms": float(np.percentile(tick_ms, 50)) if len(tick_ms) else None,
        "tick_p99_ms": float(np.percentile(tick_ms, 99)) if len(tick_ms) else None,
        "missed_deadlines": int(np.sum(tick_ms > budget_ms)),
        "scheduler_jitter": ctrl.timer.jitter_stats(),
        "n_solves": ctrl.n_solves,
        "n_unsafe_ticks": ctrl.n_unsafe,
        "tracking_rmse_m": sim.tracking_rmse(),
        "host_link_floor_p50_ms": link_ms,
        "launches": launches,
    }
    if ctrl.result_age:
        # Pipelined: how many ticks old the published command is (1: the
        # previous tick's solve); the lag that lag compensation predicts over.
        out["result_age_p50_ticks"] = float(np.percentile(ctrl.result_age, 50))
        out["result_age_max_ticks"] = int(max(ctrl.result_age))
    if len(tick_ms):
        # The measured tick minus the launch-and-synchronize floor under it.
        out["tick_p50_minus_link_ms"] = round(
            max(out["tick_p50_ms"] - link_ms, 0.0), 2)
    return out


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=600)
    ap.add_argument("--rate", type=float, default=50.0)
    ap.add_argument("--pipelined", action="store_true")
    ap.add_argument("--no-lag-comp", action="store_true")
    ap.add_argument("--result-delay", type=int, default=0,
                    help="pipelined: hold each result this many ticks")
    ap.add_argument("--v", type=float, default=8.0)
    ap.add_argument("--radius", type=float, default=30.0)
    ap.add_argument("--base-port", type=int, default=49500)
    ap.add_argument("--device", default="cuda",
                    help="the solver's device; cpu runs the plain versions")
    args = ap.parse_args(argv)
    print(json.dumps(
        run_deployment_loop(args.ticks, args.rate, base_port=args.base_port,
                            v_target=args.v, pipelined=args.pipelined,
                            lag_compensation=not args.no_lag_comp,
                            result_delay_ticks=args.result_delay,
                            track_radius=args.radius, device=args.device),
        indent=1,
    ))


if __name__ == "__main__":
    main()
