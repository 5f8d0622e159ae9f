"""Result plots: tracking, experiment grids, GP inference, covariances.

Port of ``ad_mpc_tpu/utils/visualization.py``. What a plot shows is
computed by numpy functions that need no plotting library
(:func:`tracking_errors`, :func:`sigma_bands`, :func:`ellipse_axes`); the
plotting functions import matplotlib inside themselves (headless, Agg),
so that the port runs where matplotlib is missing. Each returns the
figure and saves it when given a path.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def tracking_errors(t, x_executed, x_ref, t_ref=None):
    """(m, 3) position errors of the executed path against the reference
    interpolated at the times ``t``."""
    t, x_executed, x_ref = map(np.asarray, (t, x_executed, x_ref))
    t_ref = t if t_ref is None else np.asarray(t_ref)
    ref_i = np.stack([np.interp(t, t_ref, x_ref[:, k]) for k in range(3)], axis=1)
    return x_executed[:, :3] - ref_i


def sigma_bands(mu, var, n_std: float = 3.0):
    """(lower, upper) bands ``mu -+ n_std sqrt(var)``."""
    mu = np.asarray(mu)
    s = n_std * np.sqrt(np.asarray(var))
    return mu - s, mu + s


def ellipse_axes(P, n_std: float = 3.0):
    """(width, height, angle in degrees) of the ``n_std`` ellipse of a 2x2
    covariance."""
    w, V = np.linalg.eigh(np.asarray(P))
    w = np.maximum(w, 0.0)
    ang = np.degrees(np.arctan2(V[1, 1], V[0, 1]))
    return 2 * n_std * np.sqrt(w[1]), 2 * n_std * np.sqrt(w[0]), ang


def trajectory_tracking_results(t, x_executed, x_ref, t_ref=None, title: str = "",
                                save_path=None):
    """3D path and per-axis position error over time."""
    plt = _plt()
    x_executed, x_ref = np.asarray(x_executed), np.asarray(x_ref)
    err = tracking_errors(t, x_executed, x_ref, t_ref)
    fig = plt.figure(figsize=(10, 4))
    ax3d = fig.add_subplot(1, 2, 1, projection="3d")
    ax3d.plot(*x_executed[:, :3].T, label="executed")
    ax3d.plot(*x_ref[:, :3].T, "--", label="reference")
    ax3d.legend()
    ax3d.set_title(title or "tracking")
    ax = fig.add_subplot(1, 2, 2)
    for k, lab in enumerate("xyz"):
        ax.plot(t, err[:, k], label=f"e_{lab}")
    ax.plot(t, np.linalg.norm(err, axis=1), "k", label="|e|")
    ax.set_xlabel("t [s]")
    ax.set_ylabel("position error [m]")
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=110)
    return fig


def mse_tracking_experiment_plot(v_list, mse, model_names, traj_names, t_opt=None,
                                 save_path=None):
    """Tracking error against speed, per trajectory type and model; ``mse``
    (n_traj, n_speeds, n_models)."""
    plt = _plt()
    mse = np.asarray(mse)
    n_traj = mse.shape[0]
    fig, axes = plt.subplots(1, n_traj, figsize=(4 * n_traj, 3.2), squeeze=False)
    for i in range(n_traj):
        ax = axes[0, i]
        for m, name in enumerate(model_names):
            ax.plot(v_list, mse[i, :, m], marker="o", label=name)
        ax.set_title(traj_names[i])
        ax.set_xlabel("max speed [m/s]")
        ax.set_ylabel("RMSE [m]")
        ax.legend()
    if t_opt is not None:
        fig.suptitle(f"mean opt time: {np.mean(t_opt) * 1e3:.2f} ms")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=110)
    return fig


def gp_inference_plot(z_test, y_test, mu, var=None, dim_names=None, save_path=None):
    """Held-out residuals against the first feature: the targets and the GP
    mean with its +-3 sigma bands (:func:`sigma_bands`). z_test (m, d),
    y_test and mu (m, k), var (m, k) or None."""
    plt = _plt()
    z_test, y_test, mu = map(np.asarray, (z_test, y_test, mu))
    if y_test.ndim == 1:
        y_test, mu = y_test[:, None], mu[:, None]
    k = y_test.shape[1]
    order = np.argsort(z_test[:, 0])
    fig, axes = plt.subplots(1, k, figsize=(4 * k, 3.2), squeeze=False)
    for j in range(k):
        ax = axes[0, j]
        ax.plot(z_test[order, 0], y_test[order, j], ".", ms=3, alpha=0.5,
                label="residual")
        ax.plot(z_test[order, 0], mu[order, j], "r-", label="GP mean")
        if var is not None:
            lo, hi = sigma_bands(mu[order, j], np.asarray(var)[order, j])
            ax.fill_between(z_test[order, 0], lo, hi, color="r", alpha=0.2,
                            label="+-3 sigma")
        ax.set_title(dim_names[j] if dim_names else f"dim {j}")
        ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=110)
    return fig


def covariance_ellipses(xs, Ps, idx=(0, 1), n_std: float = 3.0, ax=None,
                        save_path=None):
    """The mean path with the ``n_std`` covariance ellipse of each state
    (:func:`ellipse_axes`), as ``ocp.propagation.forward_prop`` gives them."""
    plt = _plt()
    from matplotlib.patches import Ellipse

    xs, Ps = np.asarray(xs), np.asarray(Ps)
    i, j = idx
    if ax is None:
        fig, ax = plt.subplots(figsize=(5, 4))
    else:
        fig = ax.figure
    ax.plot(xs[:, i], xs[:, j], "b.-", ms=3, label="mean")
    for k in range(len(xs)):
        w, h, ang = ellipse_axes(Ps[k][np.ix_([i, j], [i, j])], n_std)
        ax.add_patch(Ellipse((xs[k, i], xs[k, j]), w, h, angle=ang, fc="none",
                             ec="r", alpha=0.6))
    ax.legend()
    ax.set_aspect("equal", adjustable="datalim")
    if save_path:
        fig.savefig(save_path, dpi=110)
    return fig
