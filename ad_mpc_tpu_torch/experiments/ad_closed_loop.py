"""Offline AD closed-loop experiment: the bicycle MPC tracking an oval
(port of ``ad_mpc_tpu/experiments/ad_closed_loop.py``).

The bicycle plant (``sim/simulator.py``, on the host) replaces CARLA, the
Frenet reference pipeline (``control/reference.py``, on the host)
replaces ``/local_traj``, and :class:`BicycleMPC` (the single-vehicle
SQP-RTI solver on ``device``) replaces ACADOS. Every tick: window the
track ahead of the car, build the reference, solve (the plausibility gate
is the tick's one host fetch), apply u0 to the plant.

    python -m ad_mpc_tpu_torch.experiments.ad_closed_loop [--time 20]
        [--v 8] [--nodes 40] [--noisy] [--device cuda]
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ad_mpc_tpu_torch.control.mpc import BicycleMPC, bicycle_spec
from ad_mpc_tpu_torch.control.reference import PathReference, resample_vel
from ad_mpc_tpu_torch.sim.simulator import BicycleSim, DisturbanceConfig


def oval_track(n_points: int = 600, r: float = 30.0, straight: float = 60.0):
    """Oval track waypoints (two straights + two half-circles)."""
    seg = n_points // 4
    # Bottom straight: (0,0) -> (straight, 0), heading 0.
    xs1 = np.linspace(0, straight, seg, endpoint=False)
    ys1 = np.zeros(seg)
    ps1 = np.zeros(seg)
    # Right half-circle up.
    th = np.linspace(-np.pi / 2, np.pi / 2, seg, endpoint=False)
    xs2 = straight + r * np.cos(th)
    ys2 = r + r * np.sin(th)
    ps2 = th + np.pi / 2
    # Top straight: back.
    xs3 = np.linspace(straight, 0, seg, endpoint=False)
    ys3 = np.full(seg, 2 * r)
    ps3 = np.full(seg, np.pi)
    # Left half-circle down.
    th4 = np.linspace(np.pi / 2, 3 * np.pi / 2, seg, endpoint=False)
    xs4 = r * np.cos(th4)
    ys4 = r + r * np.sin(th4)
    ps4 = th4 + np.pi / 2
    x = np.concatenate([xs1, xs2, xs3, xs4])
    y = np.concatenate([ys1, ys2, ys3, ys4])
    psi = np.unwrap(np.concatenate([ps1, ps2, ps3, ps4]))
    psi = (psi + np.pi) % (2 * np.pi) - np.pi
    return x, y, psi


def track_rmse(states, track) -> float:
    """RMS distance of the states' positions to the nearest track point."""
    tx, ty, _ = track
    s = np.asarray(states)
    d = np.sqrt((s[:, None, 0] - tx[None, :]) ** 2
                + (s[:, None, 1] - ty[None, :]) ** 2).min(axis=1)
    return float(np.sqrt(np.mean(d**2)))


@dataclass
class ClosedLoopResult:
    rmse_pos: float
    mean_opt_ms: float
    p50_opt_ms: float
    p99_opt_ms: float
    v_mean: float
    n_steps: int
    states: np.ndarray
    refs: np.ndarray
    u0s: np.ndarray  # (n_steps, 2) the commands applied to the plant
    launches: dict  # kernel launches of the run, by kernel


def run_closed_loop(
    v_target: float = 8.0,
    sim_time: float = 20.0,
    n_nodes: int = 40,
    t_horizon: float = 2.0,
    disturbances: DisturbanceConfig = DisturbanceConfig(),
    seed: int = 0,
    qp_iters: int = 18,
    verbose: bool = False,
    device="cuda",
    backend: str = "auto",
    ref_dtype=torch.float32,
) -> ClosedLoopResult:
    """``sim_time`` seconds of closed loop at the spec's dt. The solver runs
    on ``device`` (float32); the reference layer on the host in
    ``ref_dtype``; the plant on the host in float64, its noise drawn from a
    generator seeded with ``seed``."""
    spec = bicycle_spec(t_horizon=t_horizon, n_nodes=n_nodes, qp_iters=qp_iters)
    mpc = BicycleMPC(spec=spec, device=device, backend=backend)
    solver = mpc.solver
    solver.vde.launches = solver.qp.launches = solver.rk4.launches = 0
    sim = BicycleSim(disturbances=disturbances, seed=seed)
    dt = spec.dt
    on_card = torch.device(device).type == "cuda"

    track = oval_track()
    tx, ty, tpsi = track
    ref_gen = PathReference(traj_horizon=n_nodes + 1, traj_dt=dt, dtype=ref_dtype)

    x = torch.tensor([0.0, 0.0, 0.0, v_target * 0.5, 0.0, 0.0, 0.0],
                     dtype=torch.float64)
    n_steps = int(sim_time / dt)
    states, refs, u0s, t_solve = [], [], [], []

    # Local-trajectory emulation: like CARLA's /local_traj, feed the
    # controller a forward window of the global track each tick.
    M = len(tx)
    for step in range(n_steps):
        xi = x.numpy()
        ci = int(np.argmin((tx - xi[0]) ** 2 + (ty - xi[1]) ** 2))
        idx = (ci + np.arange(0, 200)) % M
        ref_gen.set_traj(tx[idx], ty[idx], tpsi[idx], np.full(len(idx), v_target))
        wp = ref_gen.get_waypoints(xi[0], xi[1], xi[2])
        v_ref = resample_vel(wp.v_ref, float(xi[3]), dt, acc_max=3.0, dec_max=5.0)

        x_ref = np.zeros((n_nodes + 1, 7))
        x_ref[:, 0] = wp.x_ref.numpy()
        x_ref[:, 1] = wp.y_ref.numpy()
        x_ref[:, 2] = wp.psi_ref.numpy()
        x_ref[:, 3] = v_ref.numpy()
        mpc.set_reference(x_ref)

        tic = time.perf_counter()
        us, xs, ok = mpc.optimize(x)
        u0 = us[0].cpu()
        t_solve.append(time.perf_counter() - tic)

        x = sim.step(x, u0, dt)
        states.append(x.numpy())
        refs.append(x_ref[0])
        u0s.append(u0.double().numpy())
        if verbose and step % 40 == 0:
            print(f"t={step * dt:5.1f}s pos=({float(x[0]):7.2f},{float(x[1]):7.2f}) "
                  f"v={float(x[3]):5.2f} "
                  f"err={np.linalg.norm(x.numpy()[:2] - x_ref[1, :2]):.3f}")
    if on_card:
        torch.cuda.synchronize()

    states = np.stack(states)
    t_ms = 1e3 * np.asarray(t_solve[2:])  # the first solves build and warm up
    return ClosedLoopResult(
        rmse_pos=track_rmse(states, track),
        mean_opt_ms=float(t_ms.mean()),
        p50_opt_ms=float(np.percentile(t_ms, 50)),
        p99_opt_ms=float(np.percentile(t_ms, 99)),
        v_mean=float(states[:, 3].mean()),
        n_steps=n_steps,
        states=states,
        refs=np.stack(refs),
        u0s=np.stack(u0s),
        launches={"vde": solver.vde.launches, "lq_ipm": solver.qp.launches,
                  "rk4": solver.rk4.launches},
    )


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--v", type=float, default=8.0)
    ap.add_argument("--time", type=float, default=20.0)
    ap.add_argument("--nodes", type=int, default=40)
    ap.add_argument("--noisy", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the solver's device; cpu runs the plain versions")
    args = ap.parse_args(argv)

    res = run_closed_loop(
        v_target=args.v,
        sim_time=args.time,
        n_nodes=args.nodes,
        disturbances=DisturbanceConfig(noisy=args.noisy),
        verbose=True,
        device=args.device,
    )
    print(
        f":::::::::::::: AD CLOSED LOOP ::::::::::::::\n"
        f"n_steps={res.n_steps}  v_mean={res.v_mean:.2f} m/s\n"
        f"tracking RMSE (vs track): {res.rmse_pos:.4f} m\n"
        f"opt time mean={res.mean_opt_ms:.3f} ms  "
        f"p50={res.p50_opt_ms:.3f}  p99={res.p99_opt_ms:.3f}\n"
        f"kernel launches {res.launches}"
    )


if __name__ == "__main__":
    main()
