"""Comparative model experiment: ideal, nominal, GP and RDRv sweeps.

Port of ``ad_mpc_tpu/experiments/comparative.py``: a factory of a quad MPC
for a model option, and a closed-loop sweep over trajectory types x
speeds x models (``quad_trajectory_test.run_tracking`` on ``device``)
that keeps the result tensors and a cross-run registry under the port's
results root (``utils.io.results_root``, or ``root``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ad_mpc_tpu_torch.control.mpc import QuadMPC, quad_spec
from ad_mpc_tpu_torch.experiments.quad_trajectory_test import run_tracking
from ad_mpc_tpu_torch.learned.ensemble import GPEnsemble, quad_residual_fn
from ad_mpc_tpu_torch.sim.simulator import DisturbanceConfig
from ad_mpc_tpu_torch.utils import io
from ad_mpc_tpu_torch.utils.live_viz import ExperimentRegistry


def prepare_quad_mpc(model: str = "nominal", ensemble: Optional[GPEnsemble] = None,
                     rdrv_d: Optional[np.ndarray] = None, device="cuda", **spec_kw):
    """A QuadMPC for a model option: ``nominal``; ``gp``, the nominal plus
    ``quad_residual_fn(ensemble)``; ``rdrv``, plus the linear drag
    ``rdrv_d``. (``ideal`` is the nominal MPC against an undisturbed
    plant: a choice of the simulator, not of the controller.)"""
    spec = quad_spec(**spec_kw)
    if model == "gp":
        if ensemble is None:
            raise ValueError("model 'gp' needs an ensemble")
        return QuadMPC(spec=spec, residual_fn=quad_residual_fn(ensemble), device=device)
    if model == "rdrv":
        if rdrv_d is None:
            raise ValueError("model 'rdrv' needs rdrv_d")
        return QuadMPC(spec=spec, rdrv_d=rdrv_d, device=device)
    return QuadMPC(spec=spec, device=device)


def comparative_sweep(models: dict, traj_types=("loop", "lemniscate"), speeds=(5.0, 8.0),
                      disturbances: DisturbanceConfig = DisturbanceConfig(drag=True),
                      seed: int = 0, save_name: Optional[str] = None,
                      verbose: bool = False, device="cuda", root: Optional[str] = None,
                      launches: Optional[dict] = None):
    """``models``: name -> keyword arguments of ``run_tracking``
    (``ensemble=``, ``rdrv_d=``, ``max_steps=``, ...); the model ``ideal``
    flies without disturbances. Returns (rmse, t_opt, v_max), each
    (n_models, n_traj, n_speeds); with ``save_name`` also written under
    ``<root>/experiments/<save_name>/`` and recorded in
    ``<root>/experiments/metadata.json``. A ``launches`` dict takes each
    run's (VDE launches, solver resets) by (model, trajectory, speed)."""
    names = list(models)
    shape = (len(names), len(traj_types), len(speeds))
    rmse, t_opt, v_max = np.zeros(shape), np.zeros(shape), np.zeros(shape)
    for i, name in enumerate(names):
        for j, traj in enumerate(traj_types):
            for k, v in enumerate(speeds):
                dist = DisturbanceConfig() if name == "ideal" else disturbances
                res = run_tracking(traj_type=traj, v_max=v, disturbances=dist, seed=seed,
                                   device=device, **models[name])
                rmse[i, j, k], t_opt[i, j, k], v_max[i, j, k] = (
                    res.rmse, res.mean_opt_ms, res.v_max)
                if launches is not None:
                    launches[name, traj, v] = (res.launches["vde"], res.n_resets)
                if verbose:
                    print(f"{name:8s} {traj:11s} v={v:4.1f}: rmse={res.rmse:.5f} "
                          f"t={res.mean_opt_ms:.2f}ms", flush=True)
    if save_name:
        base = os.path.join(root or io.results_root(), "experiments")
        d = os.path.join(base, save_name)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "mse.npy"), rmse**2)
        np.save(os.path.join(d, "t_opt.npy"), t_opt)
        np.save(os.path.join(d, "mean_v.npy"), v_max)
        with open(os.path.join(d, "models.txt"), "w") as f:
            f.write("\n".join(names))
        reg = ExperimentRegistry(os.path.join(base, "metadata.json"))
        for i, name in enumerate(names):
            for j, traj in enumerate(traj_types):
                for k, v in enumerate(speeds):
                    reg.record(traj, name, v, rmse[i, j, k], t_opt[i, j, k])
    return rmse, t_opt, v_max


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the controller's device; cpu runs the plain versions")
    ap.add_argument("--max-steps", type=int, default=None)
    args = ap.parse_args(argv)
    comparative_sweep({"ideal": {"max_steps": args.max_steps},
                       "nominal": {"max_steps": args.max_steps}},
                      traj_types=("loop",), speeds=(8.0,), verbose=True,
                      save_name="comparative_demo", device=args.device)


if __name__ == "__main__":
    main()
