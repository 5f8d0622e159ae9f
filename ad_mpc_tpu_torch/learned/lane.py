"""The baked GP mean inside the dynamics.

Port of ``ad_mpc_tpu/learned/lane.py:52-148``: the posterior mean of one
(output dim, cluster) GP with its training set as constants, evaluated on
entries of any shape, the residual rows of the bicycle layout and the
quadrotor's body-frame residual. The JAX package writes it point by point
for the Pallas slab contract; here it is plain tensor code vectorized over
the training points (the kernel's version is ``csrc/vde.cu:gp_mean``).
The parameter-routed form (``lane.py:151-253``) has no caller on a bench
or experiment path and is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ad_mpc_tpu_torch.learned.ensemble import GPEnsemble


def lane_gp_mean(x_train, k_inv_y, len_scale, sigma_f, y_mean, z):
    """``mu = y_mean + sum_j a_j exp(-0.5 ||(z - X_j) / l||^2)`` with
    ``a = k_inv_y sigma_f``.

    x_train (n, d), k_inv_y (n,), len_scale (d,): host constants (numpy,
    rounded once to z's type, as the JAX package's Python floats are);
    z: d tensors of one shape S. Rows with a_j = 0 (padding) are left out,
    so they add exactly nothing. Returns the mean, of shape S.
    """
    X = np.asarray(x_train, np.float64)
    a = np.asarray(k_inv_y, np.float64) * float(sigma_f)
    inv_l = 1.0 / np.asarray(len_scale, np.float64)
    keep = a != 0.0
    zs = torch.stack(list(z))  # (d, *S)
    as_t = lambda v: torch.as_tensor(v, dtype=zs.dtype, device=zs.device)
    extra = (1,) * (zs.dim() - 1)
    Xt = as_t(X[keep]).reshape(int(keep.sum()), X.shape[1], *extra)
    t = (zs[None] - Xt) * as_t(inv_l).reshape(-1, *extra)
    terms = as_t(a[keep]).reshape(-1, *extra) * torch.exp(
        -0.5 * torch.sum(t * t, dim=1))
    return torch.sum(terms, dim=0) + float(y_mean)


def _ens_cluster(ens: GPEnsemble, dim: int, cluster) -> tuple:
    """Host-side (numpy) parameters of one (output dim, cluster) GP."""
    c = int(cluster[dim]) if np.ndim(cluster) else int(cluster)
    return (ens.x_train[dim, c], ens.k_inv_y[dim, c], ens.len_scale[dim, c],
            float(ens.sigma_f[dim, c]), float(ens.y_mean[dim, c]))


def add_rows(base, contribs: dict):
    """``base`` (nx, ...) with ``contribs[i]`` added to row i."""
    return torch.stack([base[i] + contribs[i] if i in contribs else base[i]
                        for i in range(base.shape[0])])


def lane_residual_terms(ens: GPEnsemble, x, cluster=0) -> dict:
    """The GP means of ``ens``'s ``cluster`` at the features
    ``x[feat_idx]``, by output row: ``{out_idx[k]: mean_k}``."""
    z = [x[i] for i in ens.feat_idx]
    return {dim: lane_gp_mean(*_ens_cluster(ens, k, cluster), z)
            for k, dim in enumerate(ens.out_idx)}


def _rot_rows(x):
    """R(q) of the state's [w, x, y, z] quaternion x[3:7], entrywise, as a
    3x3 list of entries (``utils.math.q_to_rot_mat``'s order)."""
    qw, qx, qy, qz = x[3], x[4], x[5], x[6]
    return [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)],
    ]


def quad_lane_residual_terms(ens: GPEnsemble, x, cluster=0) -> dict:
    """The quadrotor's body-frame GP residual, entrywise: the means at the
    body-frame velocities ``v_b = R(q)^T v``, rotated back to the world,
    ``{7 + r: (R(q) mu_b)_r}``. Serves ``feat_idx = out_idx = (7, 8, 9)``
    only."""
    if tuple(ens.feat_idx) != (7, 8, 9) or tuple(ens.out_idx) != (7, 8, 9):
        raise ValueError("the quad lane residual serves the body-frame "
                         "velocity layout (7, 8, 9) only")
    R = _rot_rows(x)
    v = [x[7], x[8], x[9]]
    v_b = [R[0][r] * v[0] + R[1][r] * v[1] + R[2][r] * v[2] for r in range(3)]
    mu_b = [lane_gp_mean(*_ens_cluster(ens, k, cluster), v_b) for k in range(3)]
    return {7 + r: R[r][0] * mu_b[0] + R[r][1] * mu_b[1] + R[r][2] * mu_b[2]
            for r in range(3)}
