"""The residual models' fitting pipeline and its CLI.

Port of ``ad_mpc_tpu/learned/fitting.py``: a residual dataset -> prune ->
cluster -> per (output dim, cluster) training-point selection -> GP
hyperparameter fit -> a stacked :class:`GPEnsemble`, the dense-GP
distillation, and the held-out evaluation (nominal against GP-corrected
RMSE). The fit is host work (numpy, scipy, float64 torch on the CPU);
the fitted model is saved as an ``.npz`` in the port's registry
(``utils.io``).

    python -m ad_mpc_tpu_torch.learned.fitting --dataset DIR [--n-clusters 2]
"""

from __future__ import annotations

import numpy as np
import torch

from ad_mpc_tpu_torch.learned.dataset import ResidualDataset, select_training_points
from ad_mpc_tpu_torch.learned.ensemble import GPEnsemble, predict
from ad_mpc_tpu_torch.learned.gp import fit_gp, kernel_vec


def fit_gp_ensemble(dataset: ResidualDataset, out_idx=(7, 8, 9), feat_idx=(7, 8, 9),
                    n_clusters: int = 1, n_points: int = 30, n_restarts: int = 3,
                    selection: str = "kmeans", seed: int = 0,
                    gmm_cache_path: str | None = None,
                    top2_thresh: float = 0.2) -> GPEnsemble:
    """One GP per (output dim, cluster), stacked. With more than one
    cluster each trains on its soft top-2 agency (a sample whose
    second-best membership exceeds ``top2_thresh`` trains both)."""
    if n_clusters > 1:
        dataset.cluster(n_clusters, feat_idx=feat_idx, seed=seed,
                        cache_path=gmm_cache_path)
        agency = dataset.cluster_agency(feat_idx=feat_idx, top2_thresh=top2_thresh)
    else:
        dataset.cluster_labels = np.zeros(len(dataset.x_in), dtype=int)
        agency = {0: np.arange(len(dataset.x_in))}

    z_all = dataset.features(feat_idx)
    gps = [[] for _ in out_idx]
    for c in sorted(agency):
        idx = agency[c]
        z = z_all[idx]
        for i, dim in enumerate(out_idx):
            y = dataset.y[idx, dim]
            sel = select_training_points(z, y, n_points, method=selection, seed=seed)
            gps[i].append(fit_gp(z[sel], y[sel], n_restarts=n_restarts, seed=seed))
    return GPEnsemble.from_gps(gps, out_idx=out_idx, feat_idx=feat_idx)


def _gp_means(gp, z):
    """Posterior means of one GP at the rows of z (m, d), float64."""
    zt = torch.as_tensor(np.asarray(z, np.float64))
    X = torch.as_tensor(np.asarray(gp.x_train, np.float64))
    ls = torch.as_tensor(np.asarray(gp.len_scale, np.float64))
    a = torch.as_tensor(np.asarray(gp.k_inv_y, np.float64))
    k = torch.stack([kernel_vec(zz, X, ls, float(gp.sigma_f)) for zz in zt])
    return (k @ a + float(gp.y_mean)).numpy()


def distill_gp(z_train, y_train, n_compact: int = 20, n_synthetic: int = 400,
               n_restarts: int = 3, seed: int = 0):
    """Dense-GP distillation: fit a dense GP on the whole training set,
    draw ``n_synthetic`` uniform queries over its slightly inflated bounding
    box, label them with its posterior mean, and fit a compact GP on
    ``n_compact`` k-means-selected synthetic points."""
    z_train = np.asarray(z_train)
    y_train = np.asarray(y_train).reshape(-1)
    rng = np.random.default_rng(seed)
    dense = fit_gp(z_train, y_train, n_restarts=n_restarts, seed=seed)
    lo, hi = z_train.min(axis=0), z_train.max(axis=0)
    pad = 0.05 * (hi - lo + 1e-9)
    z_syn = rng.uniform(lo - pad, hi + pad, size=(n_synthetic, z_train.shape[1]))
    y_syn = _gp_means(dense, z_syn)
    sel = select_training_points(z_syn, y_syn, n_compact, method="kmeans", seed=seed)
    return fit_gp(z_syn[sel], y_syn[sel], n_restarts=n_restarts, seed=seed)


def ensemble_means(ens: GPEnsemble, z):
    """(m, D) posterior means of ``ens`` at the rows of z (nearest-centroid
    cluster per row), float64 on the CPU."""
    zt = torch.as_tensor(np.asarray(z, np.float64))
    return torch.stack([predict(ens, zz) for zz in zt]).numpy()


def evaluate_ensemble(ens: GPEnsemble, test: ResidualDataset) -> dict:
    """Held-out residual RMSE: nominal (predicting 0) against GP-corrected,
    and the reduction."""
    z = test.features(ens.feat_idx)
    y = test.y[:, list(ens.out_idx)]
    mu = ensemble_means(ens, z)
    rmse_nominal = float(np.sqrt(np.mean(y**2)))
    rmse_gp = float(np.sqrt(np.mean((y - mu) ** 2)))
    return {"rmse_nominal": rmse_nominal, "rmse_gp": rmse_gp,
            "reduction": 1.0 - rmse_gp / max(rmse_nominal, 1e-12)}


def main(argv=None):
    """Load (or record) a residual dataset, prune, split, fit the GP
    ensemble, evaluate it held out, and save it in the model registry."""
    import argparse
    import json

    from ad_mpc_tpu_torch.utils import io

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default=None,
                    help="dataset directory holding data.npz; when omitted, "
                         "records fresh simulator flights")
    ap.add_argument("--model-name", default="gp_ensemble")
    ap.add_argument("--n-clusters", type=int, default=1)
    ap.add_argument("--n-points", type=int, default=30)
    ap.add_argument("--n-restarts", type=int, default=3)
    ap.add_argument("--selection", default="kmeans",
                    choices=["kmeans", "pca_cuboid", "histogram_median",
                             "random_inverse_density"])
    ap.add_argument("--x-features", type=int, nargs="+", default=[7, 8, 9])
    ap.add_argument("--y-dims", type=int, nargs="+", default=[7, 8, 9])
    ap.add_argument("--vel-cap", type=float, default=20.0)
    ap.add_argument("--hist-thresh", type=float, default=1e-3)
    ap.add_argument("--test-frac", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--record-targets", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="the recording controller's device; cpu runs the "
                         "plain versions")
    args = ap.parse_args(argv)

    if args.dataset is not None:
        arrays = io.load_arrays(args.dataset)
    else:
        from ad_mpc_tpu_torch.experiments.record_dataset import record_flights
        from ad_mpc_tpu_torch.sim.simulator import DisturbanceConfig

        print(f"# recording {args.record_targets} drag-disturbed flights")
        arrays = record_flights(n_targets=args.record_targets,
                                disturbances=DisturbanceConfig(drag=True),
                                seed=args.seed, device=args.device)

    ds = ResidualDataset.from_rollouts(arrays["x_in"], arrays["u"], arrays["x_out"],
                                       arrays["x_pred"], arrays["dt"])
    ds = ds.prune(vel_cap=args.vel_cap, hist_thresh=args.hist_thresh,
                  vel_idx=tuple(args.y_dims))
    train, test = ds.split(test_frac=args.test_frac, seed=args.seed)
    ens = fit_gp_ensemble(train, out_idx=tuple(args.y_dims),
                          feat_idx=tuple(args.x_features), n_clusters=args.n_clusters,
                          n_points=args.n_points, n_restarts=args.n_restarts,
                          selection=args.selection, seed=args.seed)
    metrics = evaluate_ensemble(ens, test)
    path = io.save_model(ens, args.model_name, metadata={
        "n_clusters": args.n_clusters, "n_points": args.n_points,
        "x_features": args.x_features, "y_dims": args.y_dims,
        "selection": args.selection, **metrics})
    print(json.dumps({"model_path": path, **metrics}))


if __name__ == "__main__":
    main()
