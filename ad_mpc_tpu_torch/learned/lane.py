"""The GP mean inside the dynamics: baked, or routed through p.

Port of ``ad_mpc_tpu/learned/lane.py``. Baked: the posterior mean of one
(output dim, cluster) GP with its training set as constants, evaluated on
entries of any shape, the residual rows of the bicycle layout and the
quadrotor's body-frame residual, of one cluster or, per evaluation, of the
nearest centroid. Parameter-routed: each scenario's
selected cluster rides in its parameter row, gathered outside the
dynamics by nearest centroid (:func:`gather_cluster_params`, and the
fleet-batched ``pack`` of :func:`param_residual_dynamics`), so that one
launch serves a fleet whose scenarios use different clusters. The JAX
package writes both point by point for the Pallas slab contract; here they
are plain tensor code vectorized over the training points (the kernels'
version is ``csrc/vde_models.cuh:gp_table_mean``).
"""

from __future__ import annotations

import numpy as np
import torch

from ad_mpc_tpu_torch.learned.ensemble import GPEnsemble


def lane_gp_mean(x_train, k_inv_y, len_scale, sigma_f, y_mean, z,
                 sequential=False):
    """``mu = y_mean + sum_j a_j exp(-0.5 ||(z - X_j) / l||^2)`` with
    ``a = k_inv_y sigma_f``.

    x_train (n, d), k_inv_y (n,), len_scale (d,): host constants (numpy,
    rounded once to z's type, as the JAX package's Python floats are);
    z: d tensors of one shape S. Rows with a_j = 0 (padding) are left out,
    so they add exactly nothing. The terms are summed by ``torch.sum``, or,
    with ``sequential``, one after another in the order of the points, as
    the kernels' ``gp_table_mean`` sums them (the float32 rounding of
    another algorithm, for the checks of ``testing.anchored_hold``).
    Returns the mean, of shape S.
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
    if not sequential:
        return torch.sum(terms, dim=0) + float(y_mean)
    total = terms[0]
    for term in terms[1:]:
        total = total + term
    return total + float(y_mean)


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


def quad_lane_residual_terms(ens: GPEnsemble, x, cluster=0,
                             mean=lane_gp_mean) -> dict:
    """The quadrotor's body-frame GP residual, entrywise: the means at the
    body-frame velocities ``v_b = R(q)^T v`` (each by ``mean``, of
    :func:`lane_gp_mean`'s signature), rotated back to the world,
    ``{7 + r: (R(q) mu_b)_r}``. Serves ``feat_idx = out_idx = (7, 8, 9)``
    only."""
    if tuple(ens.feat_idx) != (7, 8, 9) or tuple(ens.out_idx) != (7, 8, 9):
        raise ValueError("the quad lane residual serves the body-frame "
                         "velocity layout (7, 8, 9) only")
    R = _rot_rows(x)
    v = [x[7], x[8], x[9]]
    v_b = [R[0][r] * v[0] + R[1][r] * v[1] + R[2][r] * v[2] for r in range(3)]
    mu_b = [mean(*_ens_cluster(ens, k, cluster), v_b) for k in range(3)]
    return {7 + r: R[r][0] * mu_b[0] + R[r][1] * mu_b[1] + R[r][2] * mu_b[2]
            for r in range(3)}


def centroid_dists(centroids, z) -> list:
    """The squared distance of the features z (d entries) to each centroid
    of ``centroids`` (C, d; host constants rounded to z's type), summed over
    the features in order, each product and sum rounded on its own (the
    kernels' ``nearest_cluster``)."""
    cen = torch.as_tensor(np.asarray(centroids), dtype=z[0].dtype, device=z[0].device)
    out = []
    for c in range(cen.shape[0]):
        t = [cen[c, j] - zj for j, zj in enumerate(z)]
        d2 = t[0] * t[0]
        for tj in t[1:]:
            d2 = d2 + tj * tj
        out.append(d2)
    return out


def nearest_mean(centroids, means, z):
    """The mean of the nearest centroid at the features z, entrywise
    (``means``: one entry per cluster): the first strict minimum of
    :func:`centroid_dists` in cluster order, picked by ``torch.where`` as
    ``argmin`` picks it (a NaN distance never wins), so that the choice
    carries no derivative, as JAX's ``jacfwd`` through an integer index."""
    d2 = centroid_dists(centroids, z)
    best, m = d2[0], means[0]
    for c in range(1, len(means)):
        take = d2[c] < best
        m = torch.where(take, means[c], m)
        best = torch.where(take, d2[c], best)
    return m


def quad_select_residual_terms(ens: GPEnsemble, x, pin=None,
                               choose=nearest_mean, mean=lane_gp_mean) -> dict:
    """The quadrotor's clustered body-frame GP residual of
    ``quad_residual_fn(ens, fixed_cluster)``
    (``ad_mpc_tpu/learned/ensemble.py:216-244``), entrywise: the features
    are ``x[feat_idx]`` with the velocities rotated into the body frame,
    ``R(q)^T v``; each output k takes the cluster ``pin[k]``, or, with no
    pin, the nearest centroid at every evaluation (``choose(centroids,
    means, z)``, :func:`nearest_mean`); its mean (by ``mean``, of
    :func:`lane_gp_mean`'s signature) on the body velocity
    ``out_idx[k] - 7`` (zeros on the others) is rotated back,
    ``{7 + r: (R(q) mu)_r}``. The plain version of the ``GPQuadSelectDyn``
    functor."""
    if not set(ens.out_idx) <= {7, 8, 9}:
        raise ValueError(f"the quad residual corrects the velocity rows 7-9 "
                         f"only; got out_idx={ens.out_idx}")
    R = _rot_rows(x)
    v_b = [R[0][k] * x[7] + R[1][k] * x[8] + R[2][k] * x[9] for k in range(3)]
    z = [v_b[i - 7] if i in (7, 8, 9) else x[i] for i in ens.feat_idx]
    mu = [torch.zeros_like(x[7])] * 3
    for k, dim in enumerate(ens.out_idx):
        if pin is not None:
            mu[dim - 7] = mean(*_ens_cluster(ens, k, pin[k]), z)
        else:
            means = [mean(*_ens_cluster(ens, k, c), z)
                     for c in range(ens.n_clusters)]
            mu[dim - 7] = choose(ens.centroids[k], means, z)
    return {7 + r: R[r][0] * mu[0] + R[r][1] * mu[1] + R[r][2] * mu[2]
            for r in range(3)}


# ------------------------------------------------- parameter-routed clusters

def gp_param_dim(ens: GPEnsemble) -> int:
    """Entries of a parameter row holding one selected cluster per output
    dim: per dim [X flat (n*d), a (n), inv_l (d), sigma_f, y_mean]."""
    D, _, n, d = ens.x_train.shape
    return D * (n * d + n + d + 2)


def routed_table(ens: GPEnsemble) -> np.ndarray:
    """(D, C, n*d + n + d + 2) float32: each (output dim, cluster)'s part of
    a parameter row, computed in float64 and rounded once, as JAX's
    ``gather_cluster_params`` rounds it."""
    D, C, n, d = ens.x_train.shape
    X = np.asarray(ens.x_train, np.float64).reshape(D, C, n * d)
    sf = np.asarray(ens.sigma_f, np.float64)
    a = np.asarray(ens.k_inv_y, np.float64) * sf[..., None]
    inv_l = 1.0 / np.asarray(ens.len_scale, np.float64)
    ym = np.asarray(ens.y_mean, np.float64)
    return np.concatenate([X, a, inv_l, sf[..., None], ym[..., None]],
                          axis=-1).astype(np.float32)


class ClusterPacker:
    """``pack(z, base_p=None)``: each scenario's parameter row of the
    routed GP, on z's device with no host synchronization. z (B, d) or
    (d,) features; the cluster of each output dim is the nearest centroid
    (squared distance in float64), its part of the row a gather from
    :func:`routed_table`; ``base_p`` (B, b) or (b,) goes in front.
    Returns float32 (B, b + gp_param_dim) or (b + gp_param_dim,)."""

    def __init__(self, ens: GPEnsemble):
        self.ens = ens
        self._table = routed_table(ens)
        self._on = {}  # device -> (centroids float64, table float32)

    def _arrays(self, device):
        key = str(device)
        if key not in self._on:
            self._on[key] = (
                torch.as_tensor(np.asarray(self.ens.centroids, np.float64), device=device),
                torch.as_tensor(self._table, device=device))
        return self._on[key]

    def clusters(self, z):
        """(B, D) nearest-centroid cluster per output dim of each row of z."""
        cen, _ = self._arrays(z.device)
        d2 = torch.sum((cen[None] - z.to(torch.float64)[:, None, None, :]) ** 2, dim=-1)
        return torch.argmin(d2, dim=-1)

    def __call__(self, z, base_p=None):
        single = z.dim() == 1
        z = z[None] if single else z
        _, table = self._arrays(z.device)
        idx = self.clusters(z)
        dims = torch.arange(table.shape[0], device=z.device)
        gp = table[dims[None, :], idx].reshape(z.shape[0], -1)
        if base_p is not None:
            bp = torch.as_tensor(base_p, dtype=torch.float32, device=z.device)
            gp = torch.cat([bp.expand(z.shape[0], -1) if bp.dim() == 1 else bp, gp],
                           dim=1)
        return gp[0] if single else gp


def gather_cluster_params(ens: GPEnsemble, z):
    """Nearest-centroid gather for one feature point z (d,): the selected
    cluster's parameters of every output dim, flattened, float32
    (gp_param_dim,)."""
    return ClusterPacker(ens)(z)


def param_gp_mean(n: int, d: int, p, off: int, z):
    """The SE-kernel mean with the GP read from entries of p (entries
    leading; each scenario its own values): ``y_mean + sum_j a_j exp(-0.5
    sum_k ((z_k - X_jk) inv_l_k)^2)`` with X at ``p[off:]``, then a, inv_l,
    sigma_f and y_mean. z: d entries."""
    xo, ao, lo = off, off + n * d, off + n * d + n
    extra = p.shape[1:]
    X = p[xo:ao].reshape(n, d, *extra)
    inv_l = p[lo:lo + d].reshape(1, d, *extra)
    zs = torch.stack(list(z))[None]
    t = (zs - X) * inv_l
    return p[lo + d + 1] + torch.sum(p[ao:lo] * torch.exp(-0.5 * torch.sum(t * t, dim=1)),
                                     dim=0)


def param_residual_dynamics(ens: GPEnsemble, base, base_p_dim: int,
                            quad_frame: bool = False):
    """``base(x, u, p)`` plus the parameter-routed GP residual of ``ens``
    read from ``p[base_p_dim:]``. Returns ``(dynamics, p_dim, pack)``:
    the dynamics module (:mod:`ad_mpc_tpu_torch.models.gp_routed`; with a
    CUDA functor where the base and layout have one), the parameter rows,
    and the fleet-batched :class:`ClusterPacker`. ``quad_frame``: the
    features are the body-frame velocities ``R(q)^T v`` and the means are
    rotated back to the world frame."""
    from ad_mpc_tpu_torch.models.gp_routed import routed_dynamics

    dyn = routed_dynamics(ens, base, base_p_dim, quad_frame)
    return dyn, dyn.p_dim, ClusterPacker(ens)
