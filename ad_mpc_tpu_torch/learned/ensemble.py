"""Clustered GP ensembles as stacked parameter arrays.

Port of ``ad_mpc_tpu/learned/ensemble.py:29-145, 193-213``: one GP per
(output dim, cluster), padded to a common training-set size and sorted by
centroid, nearest-centroid selection, the posterior means of all output
dims, and the state-feature residual. The arrays stay on the host as
float64 numpy (the constants a dynamics bakes in); the functions take them
to the query's type and device. The quadrotor features and the variance
wait for the GP-quad path.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ad_mpc_tpu_torch.learned.gp import GPParams


class GPEnsemble(NamedTuple):
    """Stacked GP parameters over (out_dim D, clusters C, points n, feats d).

    Clusters with fewer training points are padded with copies of their
    first row whose ``k_inv_y`` is zero: padding adds nothing to the mean.
    """

    x_train: np.ndarray  # (D, C, n, d)
    k_inv_y: np.ndarray  # (D, C, n)
    len_scale: np.ndarray  # (D, C, d)
    sigma_f: np.ndarray  # (D, C)
    sigma_n: np.ndarray  # (D, C)
    y_mean: np.ndarray  # (D, C)
    centroids: np.ndarray  # (D, C, d)
    n_valid: np.ndarray  # (D, C) unpadded training-set sizes
    out_idx: tuple  # the state rows the outputs correct
    feat_idx: tuple  # the state entries that form the features z

    @property
    def n_clusters(self) -> int:
        return self.x_train.shape[1]

    @staticmethod
    def from_gps(gps: Sequence[Sequence[GPParams]], out_idx: Sequence[int],
                 feat_idx: Sequence[int]) -> "GPEnsemble":
        """Stack per-dim lists of per-cluster :class:`GPParams`, padding the
        training sets to a common size and sorting the clusters by their
        centroid's first feature."""
        D, C = len(gps), len(gps[0])
        n_max = max(int(np.shape(g.x_train)[0]) for row in gps for g in row)
        d = np.shape(gps[0][0].x_train)[1]
        x_all = np.zeros((D, C, n_max, d))
        a_all = np.zeros((D, C, n_max))
        ls, cen = np.zeros((D, C, d)), np.zeros((D, C, d))
        sf, sn, ym = np.zeros((D, C)), np.zeros((D, C)), np.zeros((D, C))
        nv = np.zeros((D, C), dtype=np.int32)
        for i, row in enumerate(gps):
            order = np.argsort([float(np.asarray(g.centroid)[0]) for g in row])
            for j, cj in enumerate(order):
                g = row[cj]
                x = np.asarray(g.x_train, np.float64)
                n = x.shape[0]
                x_all[i, j] = np.concatenate([x, np.tile(x[:1], (n_max - n, 1))])
                a_all[i, j] = np.concatenate([np.asarray(g.k_inv_y, np.float64),
                                              np.zeros(n_max - n)])
                ls[i, j] = np.asarray(g.len_scale)
                sf[i, j], sn[i, j] = float(g.sigma_f), float(g.sigma_n)
                ym[i, j] = float(g.y_mean)
                cen[i, j] = np.asarray(g.centroid)
                nv[i, j] = n
        return GPEnsemble(x_all, a_all, ls, sf, sn, ym, cen, nv,
                          tuple(int(i) for i in out_idx),
                          tuple(int(i) for i in feat_idx))


def _as(a, z):
    return torch.as_tensor(np.asarray(a), dtype=z.dtype, device=z.device)


def select_cluster(ens: GPEnsemble, z):
    """Nearest-centroid cluster index per output dim: z (d,) -> (D,)."""
    d2 = torch.sum((_as(ens.centroids, z) - z[None, None, :]) ** 2, dim=-1)
    return torch.argmin(d2, dim=-1)


def predict(ens: GPEnsemble, z, cluster_idx=None):
    """Posterior means of all output dims at the features z (d,): (D,).
    ``cluster_idx`` (D,) picks a cluster per dim; None = nearest centroid."""
    if cluster_idx is None:
        cluster_idx = select_cluster(ens, z)
    dims = torch.arange(ens.x_train.shape[0], device=z.device)
    idx = torch.as_tensor(cluster_idx, device=z.device).to(torch.long)
    pick = lambda a: _as(a, z)[dims, idx]
    x_t, a, ls = pick(ens.x_train), pick(ens.k_inv_y), pick(ens.len_scale)
    sf, ym = pick(ens.sigma_f), pick(ens.y_mean)
    diff = (z[None, None, :] - x_t) / ls[:, None, :]
    k_s = sf[:, None] * torch.exp(-0.5 * torch.sum(diff * diff, dim=-1))
    return torch.sum(k_s * a, dim=-1) + ym


def state_residual_fn(ens: GPEnsemble, fixed_cluster=None):
    """Dynamics residual ``residual(x, u)``: the GP means at the features
    ``x[feat_idx]``, placed in the rows ``out_idx`` of a zero x_dot."""

    def residual(x, u):
        z = torch.stack([x[i] for i in ens.feat_idx])
        mu = predict(ens, z, cluster_idx=fixed_cluster)
        return torch.stack([mu[ens.out_idx.index(i)] if i in ens.out_idx
                            else torch.zeros_like(x[i])
                            for i in range(x.shape[0])])

    return residual
