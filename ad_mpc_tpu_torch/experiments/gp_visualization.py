"""GP model-quality experiment: held-out residuals with +-3 sigma bands.

Port of ``ad_mpc_tpu/experiments/gp_visualization.py``: fit a residual GP
ensemble on a recorded dataset, evaluate it on the held-out split, and
give the GP means and their +-3 sigma bands (``predict_variance``) beside
the residual targets. The numbers need numpy and torch alone; the plot is
drawn only where matplotlib imports and a path is given.

    python -m ad_mpc_tpu_torch.experiments.gp_visualization --dataset DIR [--out FILE.png]
"""

from __future__ import annotations

import numpy as np
import torch


def gp_bands(ens, z):
    """(mu, var, lower, upper), each (m, D): the posterior means and
    variances of ``ens`` at the rows of z and the +-3 sigma bands, float64."""
    from ad_mpc_tpu_torch.learned.ensemble import predict_variance
    from ad_mpc_tpu_torch.learned.fitting import ensemble_means
    from ad_mpc_tpu_torch.utils.visualization import sigma_bands

    mu = ensemble_means(ens, z)
    var = torch.stack([predict_variance(ens, zz) for zz in
                       torch.as_tensor(np.asarray(z, np.float64))]).numpy()
    lo, hi = sigma_bands(mu, var)
    return mu, var, lo, hi


def run_gp_visualization(dataset=None, out_idx=(7, 8, 9), feat_idx=(7, 8, 9),
                         n_points: int = 25, save_path: str | None = None, seed: int = 0,
                         device="cuda"):
    """Returns (metrics, numbers, figure): the held-out RMSE metrics, the
    dict of features, targets, means, variances and bands, and the figure
    (None without ``save_path`` or matplotlib). ``dataset``: a
    :class:`ResidualDataset`; None records one from 6 short flights on
    ``device``."""
    from ad_mpc_tpu_torch.learned.dataset import ResidualDataset
    from ad_mpc_tpu_torch.learned.fitting import evaluate_ensemble, fit_gp_ensemble

    if dataset is None:
        from ad_mpc_tpu_torch.experiments.record_dataset import record_flights

        a = record_flights(n_targets=6, seed=seed, device=device)
        dataset = ResidualDataset.from_rollouts(a["x_in"], a["u"], a["x_out"],
                                                a["x_pred"], a["dt"])
    train, test = dataset.split(test_frac=0.3, seed=seed)
    ens = fit_gp_ensemble(train, out_idx=out_idx, feat_idx=feat_idx, n_points=n_points,
                          seed=seed)
    metrics = evaluate_ensemble(ens, test)
    z = test.features(feat_idx)
    y = test.y[:, list(out_idx)]
    mu, var, lo, hi = gp_bands(ens, z)
    numbers = {"z": z, "y": y, "mu": mu, "var": var, "lower": lo, "upper": hi}
    fig = None
    if save_path:
        try:
            from ad_mpc_tpu_torch.utils.visualization import gp_inference_plot

            fig = gp_inference_plot(z, y, mu, var=var,
                                    dim_names=[f"v_dot[{i}]" for i in out_idx],
                                    save_path=save_path)
        except ImportError:
            fig = None
    return metrics, numbers, fig


def main(argv=None):
    import argparse

    from ad_mpc_tpu_torch.learned.dataset import ResidualDataset
    from ad_mpc_tpu_torch.utils import io

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default=None,
                    help="a directory holding data.npz; default: record 6 flights")
    ap.add_argument("--out", default=None, help="the plot's path (needs matplotlib)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ds = None
    if args.dataset:
        a = io.load_arrays(args.dataset)
        ds = ResidualDataset.from_rollouts(a["x_in"], a["u"], a["x_out"], a["x_pred"],
                                           a["dt"])
    metrics, numbers, fig = run_gp_visualization(ds, save_path=args.out,
                                                 device=args.device)
    inside = float(np.mean((numbers["y"] >= numbers["lower"])
                           & (numbers["y"] <= numbers["upper"])))
    print(f"nominal RMSE {metrics['rmse_nominal']:.4f}  GP RMSE {metrics['rmse_gp']:.4f}  "
          f"reduction {100 * metrics['reduction']:.1f}%  inside +-3 sigma {inside:.3f}"
          + (f"  -> {args.out}" if fig is not None else ""))


if __name__ == "__main__":
    main()
