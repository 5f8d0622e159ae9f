"""Offline quadrotor tracking simulation, the reference's smoke test (port
of ``ad_mpc_tpu/experiments/quad_trajectory_test.py``).

A loop, lemniscate or random min-snap reference by differential flatness
(``trajectories``), tracked in closed loop by :class:`QuadMPC` (the
single-vehicle SQP-RTI solver on ``device``) against the disturbance-suite
plant (``sim/simulator.py:QuadrotorSim``, on the host). Every tick: window
the dense reference onto the horizon, solve (the watchdog's fetch is the
solve's one host synchronization), bring u0 to the host, step the plant.
The reference oracle is an RMSE of about 0.24 m on the loop at 8 m/s with
disturbances.

    python -m ad_mpc_tpu_torch.experiments.quad_trajectory_test
        [--traj loop|lemniscate|random] [--v 8] [--no-dist] [--device cuda]
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ad_mpc_tpu_torch.control.mpc import QuadMPC, quad_spec
from ad_mpc_tpu_torch.sim.simulator import DisturbanceConfig, QuadrotorSim
from ad_mpc_tpu_torch.trajectories import (
    lemniscate_trajectory,
    loop_trajectory,
    random_trajectory,
)
from ad_mpc_tpu_torch.utils.math import interpol_mse


def get_reference_chunk(traj, u_traj, t_ref, t_now, n_nodes, dt_node):
    """The dense reference windowed and downsampled onto the MPC horizon:
    (N+1, 13) states and (N, 4) inputs from the sample at ``t_now``."""
    i0 = int(np.searchsorted(t_ref, t_now))
    ref_dt = t_ref[1] - t_ref[0]
    stride = max(int(round(dt_node / ref_dt)), 1)
    idx = i0 + stride * np.arange(n_nodes + 1)
    idx = np.clip(idx, 0, len(t_ref) - 1)
    return traj[idx], u_traj[np.clip(idx[:-1], 0, len(u_traj) - 1)]


@dataclass
class QuadTrackingResult:
    rmse: float
    mean_opt_ms: float
    v_max: float
    n_steps: int
    p50_opt_ms: float = float("nan")
    p99_opt_ms: float = float("nan")
    n_resets: int = 0
    launches: dict = None  # the solver's kernel launches over the run
    u0s: np.ndarray = None  # (n_steps, 4) the applied commands


def reference(traj_type: str, v_max: float, seed: int = 0):
    """(traj (n, 13), t_ref (n,), u_traj (n, 4)) of a family at v_max."""
    if traj_type == "loop":
        return loop_trajectory(v_max=v_max, radius=5.0)
    if traj_type == "lemniscate":
        return lemniscate_trajectory(v_max=v_max, radius=5.0)
    if traj_type == "random":
        # v_max maps to the average-speed time allocation.
        return random_trajectory(seed=seed, speed=v_max)
    raise ValueError(traj_type)


def tracking_steps(t_ref, control_period: float = 0.02, max_steps: int | None = None) -> int:
    """The ticks of :func:`run_tracking` on a reference of times ``t_ref``:
    one RTI solve each, so one launch of each kernel (a solver reset adds
    one more)."""
    n_steps = int(t_ref[-1] / control_period)
    return n_steps if max_steps is None else min(n_steps, max_steps)


def run_tracking(
    traj_type: str = "loop",
    v_max: float = 8.0,
    disturbances: DisturbanceConfig = DisturbanceConfig(
        noisy=True, drag=True, payload=False, motor_noise=True
    ),
    n_nodes: int = 10,
    t_horizon: float = 1.0,
    control_period: float = 0.02,
    sim_dt: float = 5e-4,
    seed: int = 0,
    residual_fn=None,
    rdrv_d=None,
    ensemble=None,
    qp_iters: int = 15,
    max_steps: int | None = None,
    verbose: bool = False,
    device="cuda",
    backend: str = "auto",
    dtype=torch.float32,
) -> QuadTrackingResult:
    """Track the ``traj_type`` reference at ``v_max``. ``ensemble``: a
    fitted :class:`~ad_mpc_tpu_torch.learned.ensemble.GPEnsemble` through
    QuadMPC's dual-state GP mode; ``residual_fn`` the simpler fixed
    closure; ``rdrv_d`` the linear drag matrix. The solve time of a tick
    runs until u0 is on the host; its mean, p50 and p99 leave out the first
    two solves (they build and warm up)."""
    traj, t_ref, u_traj = reference(traj_type, v_max, seed)
    spec = quad_spec(n_nodes=n_nodes, t_horizon=t_horizon, qp_iters=qp_iters)
    mpc = QuadMPC(spec=spec, residual_fn=residual_fn, rdrv_d=rdrv_d,
                  ensemble=ensemble, dtype=dtype, device=device, backend=backend)
    sim = QuadrotorSim(disturbances=disturbances, sim_dt=sim_dt, seed=seed)
    solver = mpc.solver

    x = torch.as_tensor(traj[0], dtype=torch.float64)
    n_steps = tracking_steps(t_ref, control_period, max_steps)
    states, times, t_solve, u0s = [], [], [], []

    for step in range(n_steps):
        t_now = step * control_period
        x_ref, u_ref = get_reference_chunk(traj, u_traj, t_ref, t_now, n_nodes,
                                           spec.dt)
        mpc.set_reference(x_ref, u_ref)

        tic = time.perf_counter()
        us, _ = mpc.optimize(x)
        u0 = us[0].cpu()
        t_solve.append(time.perf_counter() - tic)

        x = sim.step(x, u0, control_period)
        states.append(x.numpy())
        times.append(t_now + control_period)
        u0s.append(u0.double().numpy())
        if verbose and step % 100 == 0:
            err = np.linalg.norm(x.numpy()[:3] - x_ref[1, :3])
            print(f"t={t_now:5.2f}s err={err:.3f} "
                  f"v={np.linalg.norm(x.numpy()[7:10]):.2f}")

    states = np.stack(states)
    t_ms = 1e3 * np.asarray(t_solve[2:])
    return QuadTrackingResult(
        rmse=interpol_mse(np.asarray(times), states[:, :3], t_ref, traj[:, :3]),
        mean_opt_ms=float(t_ms.mean()),
        v_max=float(np.max(np.linalg.norm(states[:, 7:10], axis=1))),
        n_steps=n_steps,
        p50_opt_ms=float(np.percentile(t_ms, 50)),
        p99_opt_ms=float(np.percentile(t_ms, 99)),
        n_resets=mpc.n_resets,
        launches={"vde": solver.vde.launches, "lq_ipm": solver.qp.launches,
                  "rk4": solver.rk4.launches},
        u0s=np.stack(u0s),
    )


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traj", default="loop",
                    choices=["loop", "lemniscate", "random"])
    ap.add_argument("--v", type=float, default=8.0)
    ap.add_argument("--no-dist", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the solver's device; cpu runs the plain versions")
    args = ap.parse_args(argv)

    dist = (
        DisturbanceConfig()
        if args.no_dist
        else DisturbanceConfig(noisy=True, drag=True, motor_noise=True)
    )
    res = run_tracking(traj_type=args.traj, v_max=args.v, disturbances=dist,
                       verbose=True, device=args.device)
    print(
        f":::::::::::::: QUAD TRACKING ({args.traj} @ {args.v} m/s) ::::::::::::::\n"
        f"n_steps={res.n_steps}  v_max={res.v_max:.2f} m/s\n"
        f"tracking RMSE: {res.rmse:.4f} m   (reference oracle: ~0.24 m)\n"
        f"opt time mean={res.mean_opt_ms:.3f} ms  p50={res.p50_opt_ms:.3f}  "
        f"p99={res.p99_opt_ms:.3f}\n"
        f"solver resets {res.n_resets}, kernel launches {res.launches}"
    )


if __name__ == "__main__":
    main()
