"""The flagship learned-model experiment: record -> fit -> sweep.

Port of ``ad_mpc_tpu/experiments/gp_flagship.py``, the reference's headline
result (a GP residual cuts closed-loop tracking error under unmodelled
drag) through the port's own pipeline on ``device``:

1. ``record``: aggressive random point-to-point flights under drag
   (``record_dataset.record_flights``);
2. ``fit``: the body-frame residual dataset -> prune -> split -> GP
   ensembles of 1 and ``--clusters`` clusters and the RDRv drag matrix
   (``learned/``); the deployed cluster count is the candidate with the
   lower closed-loop RMSE on two short validation cells;
3. ``sweep``: nominal against GP (QuadMPC's dual-state mode) against RDRv
   in closed loop, over three trajectory families x three speeds
   (``comparative.comparative_sweep``).

Each stage writes under ``<results root>/experiments/gp_flagship<tag>/``
(``utils.io.results_root``: ``results/torch`` of the repo, or
``$AD_MPC_TORCH_RESULTS_DIR``), never into the JAX package's ``results/``.
``--dataset`` fits from another recording, such as the JAX package's
committed ``results/experiments/gp_flagship/dataset`` (read only).
``--model carried`` sweeps with the JAX package's fitted model carried
across in ``ad_mpc_tpu_torch/data/`` (``gp_flagship_c1.npz``,
``rdrv_d.npy``) in place of the port's own fit: it changes what is
loaded, not what is computed.

    python -m ad_mpc_tpu_torch.experiments.gp_flagship [--stage all|record|fit|sweep]
        [--tag T] [--dataset DIR] [--model fitted|carried] [--traj ...]
        [--speeds ...] [--max-steps M] [--seed S] [--device cuda]
"""

from __future__ import annotations

import json
import os

import numpy as np

from ad_mpc_tpu_torch.utils import io

# Per-family speed axes at the operating points where unmodelled drag
# degrades nominal tracking; ``random`` speeds are average-speed time
# allocations (the JAX package's, ``gp_flagship.py:166-170``).
FAMILY_SPEEDS = {
    "loop": (8.0, 10.0, 12.0),
    "lemniscate": (6.0, 7.0, 8.0),
    "random": (3.0, 4.0, 5.0),
}
# The closed-loop validation cells of the cluster-count choice.
VALIDATION_CELLS = (dict(traj_type="random", v_max=3.0, max_steps=400),
                    dict(traj_type="loop", v_max=10.0, max_steps=400))


def validation_cell(cell: dict, max_steps=None) -> dict:
    """``cell``, its steps capped at ``max_steps`` when given."""
    if max_steps is None:
        return cell
    return cell | {"max_steps": min(cell["max_steps"], max_steps)}


def flag_dir(tag: str = "", root: str | None = None) -> str:
    d = os.path.join(root or io.results_root(), "experiments", f"gp_flagship{tag}")
    os.makedirs(d, exist_ok=True)
    return d


def _drag():
    from ad_mpc_tpu_torch.sim.simulator import DisturbanceConfig

    return DisturbanceConfig(drag=True)


def stage_record(tag="", n_targets=24, box=6.0, seed=0, verbose=True, device="cuda",
                 root=None, max_steps=None):
    """Record drag-disturbed flights (each at most ``max_steps`` control
    periods when given); write the arrays and their meta."""
    from ad_mpc_tpu_torch.experiments.record_dataset import record_flights

    arrays = record_flights(n_targets=n_targets, box=box, disturbances=_drag(), seed=seed,
                            verbose=verbose, device=device, max_steps=max_steps)
    d = flag_dir(tag, root)
    os.makedirs(os.path.join(d, "dataset"), exist_ok=True)
    io.save_arrays(os.path.join(d, "dataset"), **arrays)
    v = np.linalg.norm(arrays["x_in"][:, 7:10], axis=1)
    meta = {"n_samples": int(len(arrays["dt"])), "v_mean": float(v.mean()),
            "v_max": float(v.max())}
    with open(os.path.join(d, "record_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return arrays, meta


def stage_fit(tag="", n_clusters=2, n_points=60, n_restarts=3, seed=0, dataset=None,
              device="cuda", root=None, verbose=True, max_steps=None):
    """Fit the GP ensembles of 1 and ``n_clusters`` clusters and the RDRv
    drag matrix from a recording (``dataset``: a directory holding
    ``data.npz``; default this tag's own), fly each candidate on the two
    validation cells, and keep the one of lower mean validation RMSE (an
    offline residual metric alone misjudges a candidate that
    misgeneralizes in closed loop). Every candidate is saved in the model
    registry as ``gp_flagship<tag>_c<clusters>``, the chosen one also as
    ``gp_flagship<tag>``. ``max_steps`` shortens the validation cells.
    Returns (ensemble, rdrv_d, meta)."""
    from ad_mpc_tpu_torch.experiments.quad_trajectory_test import run_tracking
    from ad_mpc_tpu_torch.learned.dataset import ResidualDataset
    from ad_mpc_tpu_torch.learned.fitting import evaluate_ensemble, fit_gp_ensemble
    from ad_mpc_tpu_torch.learned.rdrv import fit_rdrv

    d = flag_dir(tag, root)
    arrays = io.load_arrays(dataset or os.path.join(d, "dataset"))
    ds = ResidualDataset.from_rollouts(arrays["x_in"], arrays["u"], arrays["x_out"],
                                       arrays["x_pred"], arrays["dt"])
    ds = ds.prune(vel_cap=20.0, hist_thresh=1e-3, vel_idx=(7, 8, 9))
    train, test = ds.split(test_frac=0.2, seed=seed)
    fits = []
    for nc in sorted({1, n_clusters}):
        e = fit_gp_ensemble(train, out_idx=(7, 8, 9), feat_idx=(7, 8, 9), n_clusters=nc,
                            n_points=n_points, n_restarts=n_restarts, seed=seed)
        m = evaluate_ensemble(e, test)
        runs = [run_tracking(ensemble=e, disturbances=_drag(), seed=seed, device=device,
                             **validation_cell(c, max_steps)) for c in VALIDATION_CELLS]
        m["val_rmse"] = [r.rmse for r in runs]
        m["val_launches"] = [r.launches["vde"] for r in runs]
        m["val_resets"] = [r.n_resets for r in runs]
        m["val_rmse_mean"] = float(np.mean([v if np.isfinite(v) else 1e3
                                            for v in m["val_rmse"]]))
        io.save_model(e, f"gp_flagship{tag}_c{nc}", metadata={"n_clusters": nc, **m},
                      root=root)
        if verbose:
            print(f"# candidate {nc} cluster(s): {m}", flush=True)
        fits.append((nc, e, m))
    nc_best, ens, offline = min(fits, key=lambda t: t[2]["val_rmse_mean"])
    rdrv_d = fit_rdrv(train)
    offline = {**offline, "n_clusters_selected": nc_best,
               "candidates": {str(nc): {"offline_reduction": m["reduction"],
                                        "val_rmse": m["val_rmse"],
                                        "val_rmse_mean": m["val_rmse_mean"],
                                        "val_launches": m["val_launches"],
                                        "val_resets": m["val_resets"]}
                              for nc, _, m in fits}}
    io.save_model(ens, f"gp_flagship{tag}", metadata={"n_clusters": nc_best,
                                                      "n_points": n_points, **offline},
                  root=root)
    np.save(os.path.join(d, "rdrv_d.npy"), rdrv_d)
    with open(os.path.join(d, "fit_meta.json"), "w") as f:
        json.dump({"offline_heldout": offline, "rdrv_diag": np.diag(rdrv_d).tolist(),
                   "dataset": dataset or "own recording"}, f, indent=1)
    return ens, rdrv_d, offline


def flagship_launches(family_speeds=None, seed=0) -> dict:
    """The launches of QuadMPC's GP and RDRv functors (``GPQuadDualDyn``,
    ``QuadDragDyn``: one VDE launch per RTI solve, ``run_tracking``'s
    ticks, :func:`tracking_steps`) in the flagship, counted from its code
    without flying it: per sweep (``stage_sweep``, one model: the own fit
    or the carried one) each cell's ticks, the same for the GP and the
    RDRv rows; and the validation flights of ``stage_fit`` (two
    candidates, 1 and 2 clusters, each on :data:`VALIDATION_CELLS` through
    ``GPQuadDualDyn``). A solver reset adds one launch to its run."""
    from ad_mpc_tpu_torch.experiments.quad_trajectory_test import reference, tracking_steps

    family_speeds = family_speeds or FAMILY_SPEEDS
    cells = {f"{fam} {v}": tracking_steps(reference(fam, v, seed)[1])
             for fam, speeds in family_speeds.items() for v in speeds}
    val = [tracking_steps(reference(c["traj_type"], c["v_max"], seed)[1],
                          max_steps=c["max_steps"]) for c in VALIDATION_CELLS]
    sweep = sum(cells.values())
    return {"cells": cells, "validation_cells": val,
            "GPQuadDualDyn": {"sweep": sweep, "validation": 2 * sum(val)},
            "QuadDragDyn": {"sweep": sweep}}


def load_fitted(tag="", model="fitted", root=None):
    """(ensemble, rdrv_d): the port's own fit of ``tag`` (``fitted``), or
    the JAX package's fitted model carried across (``carried``)."""
    if model == "carried":
        from ad_mpc_tpu_torch.experiments.quad_fleet import fitted_ensemble, fitted_rdrv_d

        return fitted_ensemble(), fitted_rdrv_d()
    if model != "fitted":
        raise ValueError(f"model {model!r} not in ('fitted', 'carried')")
    ens = io.load_model(f"gp_flagship{tag}", root=root)
    return ens, np.load(os.path.join(flag_dir(tag, root), "rdrv_d.npy"))


def stage_sweep(tag="", family_speeds=None, max_steps=None, seed=0, verbose=True,
                model="fitted", device="cuda", root=None):
    """Closed-loop nominal against GP against RDRv under drag: one
    comparative sweep per family on its own speed axis, assembled into
    (n_models, n_families, n_speeds) tensors and ``sweep_summary.json``
    (with the mean RMSE reductions of GP and RDRv against nominal)."""
    from ad_mpc_tpu_torch.experiments.comparative import comparative_sweep

    family_speeds = family_speeds or FAMILY_SPEEDS
    ens, rdrv_d = load_fitted(tag, model, root)
    models = {"nominal": {}, "gp": {"ensemble": ens}, "rdrv": {"rdrv_d": rdrv_d}}
    if max_steps is not None:
        for m in models.values():
            m["max_steps"] = max_steps
    families = list(family_speeds)
    n_speeds = len(next(iter(family_speeds.values())))
    shape = (len(models), len(families), n_speeds)
    rmse, t_opt, v_max = (np.zeros(shape) for _ in range(3))
    for j, fam in enumerate(families):
        r, t, v = comparative_sweep(models, traj_types=(fam,),
                                    speeds=tuple(family_speeds[fam]),
                                    disturbances=_drag(), seed=seed,
                                    save_name=f"gp_flagship{tag}_sweep_{fam}",
                                    verbose=verbose, device=device, root=root)
        rmse[:, j], t_opt[:, j], v_max[:, j] = r[:, 0], t[:, 0], v[:, 0]
    summary = {
        "model": model,
        "families": families,
        "speeds": {f: list(v) for f, v in family_speeds.items()},
        "models": list(models),
        "rmse": rmse.tolist(),
        "t_opt_ms": t_opt.tolist(),
        "v_max": v_max.tolist(),
        "gp_reduction_mean": float(1.0 - (rmse[1] / rmse[0]).mean()),
        "gp_reduction_per_cell": (1.0 - rmse[1] / rmse[0]).tolist(),
        "rdrv_reduction_mean": float(1.0 - (rmse[2] / rmse[0]).mean()),
        "rdrv_reduction_per_family": {fam: float(1.0 - (rmse[2, j] / rmse[0, j]).mean())
                                      for j, fam in enumerate(families)},
    }
    with open(os.path.join(flag_dir(tag, root), "sweep_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    if verbose:
        print(json.dumps({k: summary[k] for k in ("gp_reduction_mean",
                                                   "rdrv_reduction_mean")}))
    return summary


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", default="all", choices=["all", "record", "fit", "sweep"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--targets", type=int, default=24)
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--points", type=int, default=60)
    ap.add_argument("--restarts", type=int, default=3,
                    help="L-BFGS-B restarts of each GP's hyperparameter fit")
    ap.add_argument("--dataset", default=None,
                    help="the recording to fit (a directory holding data.npz); "
                         "default: this tag's own")
    ap.add_argument("--model", default="fitted", choices=["fitted", "carried"],
                    help="sweep the port's own fit, or the JAX package's fitted "
                         "model carried across")
    ap.add_argument("--speeds", type=float, nargs="+", default=None,
                    help="one speed axis for every family in --traj")
    ap.add_argument("--traj", nargs="+", default=["loop", "lemniscate", "random"])
    ap.add_argument("--max-steps", type=int, default=None,
                    help="cap every closed-loop run: the recorded flights per "
                         "target, the validation cells and the sweep's cells")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the controllers' device; cpu runs the plain versions")
    args = ap.parse_args(argv)

    if args.stage in ("all", "record"):
        _, meta = stage_record(args.tag, n_targets=args.targets, seed=args.seed,
                               device=args.device, max_steps=args.max_steps)
        print(f"# recorded: {meta}", flush=True)
    if args.stage in ("all", "fit"):
        _, rdrv_d, offline = stage_fit(args.tag, n_clusters=args.clusters,
                                       n_points=args.points, n_restarts=args.restarts,
                                       seed=args.seed,
                                       dataset=args.dataset, device=args.device,
                                       max_steps=args.max_steps)
        print(f"# offline held-out: {offline}; rdrv diag {np.diag(rdrv_d).tolist()}",
              flush=True)
    if args.stage in ("all", "sweep"):
        fs = {f: tuple(args.speeds) if args.speeds else FAMILY_SPEEDS[f]
              for f in args.traj}
        stage_sweep(args.tag, family_speeds=fs, max_steps=args.max_steps, seed=args.seed,
                    model=args.model, device=args.device)


if __name__ == "__main__":
    main()
