"""Clustered GP ensembles as stacked parameter arrays.

Port of ``ad_mpc_tpu/learned/ensemble.py``: one GP per (output dim,
cluster), padded to a common training-set size and sorted by centroid,
nearest-centroid selection, the posterior means and variances of all
output dims, the state-feature residual and the quadrotor's body-frame
residual
(the matrix form that ``lane.quad_lane_residual_terms`` is held to). The
arrays stay on the host as float64 numpy (the constants a dynamics bakes
in), or, after :func:`on_device`, as tensors on the card; the functions
take them to the query's type and device, so that on the card's copy
:func:`select_cluster`, :func:`predict` and :func:`body_frame_features`
run with no host synchronization. :func:`load_npz` reads an ensemble
carried across from the JAX package (``convert.save_gp_ensemble``) with
numpy alone.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ad_mpc_tpu_torch.learned.gp import GPParams
from ad_mpc_tpu_torch.utils.math import quaternion_inverse, v_dot_q


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
    if isinstance(a, torch.Tensor):
        return a.to(dtype=z.dtype, device=z.device)
    return torch.as_tensor(np.asarray(a), dtype=z.dtype, device=z.device)


def on_device(ens: GPEnsemble, dtype, device) -> GPEnsemble:
    """``ens`` with its float arrays as tensors of ``dtype`` on ``device``
    (``n_valid`` and the index tuples as they are): one copy, so that the
    functions of this module read them where they run."""
    floats = ("x_train", "k_inv_y", "len_scale", "sigma_f", "sigma_n",
              "y_mean", "centroids")
    return ens._replace(**{k: torch.tensor(np.array(getattr(ens, k)),
                                              dtype=dtype, device=device)
                           for k in floats})


def homogeneous_feature_space(ens: GPEnsemble) -> bool:
    """True when every output dim has the same cluster centroids, so that
    one selection serves them all."""
    if ens.x_train.shape[0] == 1:
        return True
    cen = np.asarray(ens.centroids)
    return bool(np.all(cen == cen[0:1]))


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


def predict_variance(ens: GPEnsemble, z, cluster_idx=None):
    """Posterior variances of all output dims at the features z (d,): (D,).

    Each from its cluster's training set with a Cholesky-free solve; the
    padded rows (beyond ``n_valid``) are no observations: their ``k_s``
    entries are zeroed and their rows and columns of K made the identity,
    so that the solve ignores them exactly."""
    if cluster_idx is None:
        cluster_idx = select_cluster(ens, z)
    dims = torch.arange(ens.x_train.shape[0], device=z.device)
    idx = torch.as_tensor(cluster_idx, device=z.device).to(torch.long)
    pick = lambda a: _as(a, z)[dims, idx]
    x_t, ls = pick(ens.x_train), pick(ens.len_scale)
    sf, sn = pick(ens.sigma_f), pick(ens.sigma_n)
    nv = torch.as_tensor(np.asarray(ens.n_valid), device=z.device)[dims, idx]
    n = x_t.shape[1]
    m = (torch.arange(n, device=z.device)[None, :] < nv[:, None]).to(z.dtype)
    diff = (x_t[:, :, None, :] - x_t[:, None, :, :]) / ls[:, None, None, :]
    K = sf[:, None, None] * torch.exp(-0.5 * torch.sum(diff * diff, dim=-1))
    K = K * m[:, :, None] * m[:, None, :] + torch.diag_embed(1.0 - m)
    K = K + (sn**2 + 1e-6)[:, None, None] * torch.diag_embed(m)
    ds = (z[None, None, :] - x_t) / ls[:, None, :]
    k_s = sf[:, None] * torch.exp(-0.5 * torch.sum(ds * ds, dim=-1)) * m
    sol = torch.linalg.solve(K, k_s)
    return torch.clamp(sf - torch.sum(k_s * sol, dim=-1), min=1e-12)


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


def body_frame_features(x, feat_idx):
    """The features ``x[feat_idx]`` of a 13-state quad x (13,), with the
    velocity block x[7:10] rotated into the body frame, ``R(q)^T v``."""
    v_b = v_dot_q(x[7:10], quaternion_inverse(x[3:7]))
    x_body = torch.cat([x[:7], v_b, x[10:]])
    return torch.stack([x_body[i] for i in feat_idx])


class QuadResidual(NamedTuple):
    """Quadrotor residual ``residual(x, u)``: ``x_dot[7:10] += R(q)
    GP(z)`` with z the body-frame features; only the velocity rows may be
    outputs. ``fixed_cluster`` (D,) pins the cluster per dim; None selects
    the nearest centroid at every evaluation. A callable that states its
    ensemble, so that a controller can tell which dynamics it is."""

    ensemble: GPEnsemble
    fixed_cluster: object = None

    def __call__(self, x, u):
        ens = self.ensemble
        z = body_frame_features(x, ens.feat_idx)
        mu_body = predict(ens, z, cluster_idx=self.fixed_cluster)
        full = [torch.zeros_like(x[0])] * 3
        for k, dim in enumerate(ens.out_idx):
            full[dim - 7] = mu_body[k]
        mu_world = v_dot_q(torch.stack(full), x[3:7])
        return torch.cat([torch.zeros_like(x[:7]), mu_world,
                          torch.zeros_like(x[10:])])


def quad_residual_fn(ens: GPEnsemble, fixed_cluster=None) -> QuadResidual:
    """The quadrotor's body-frame residual of ``ens`` (:class:`QuadResidual`)."""
    return QuadResidual(ens, fixed_cluster)


def load_npz(path) -> GPEnsemble:
    """A :class:`GPEnsemble` from an ``.npz`` holding one array per field
    (``out_idx`` and ``feat_idx`` as integer arrays), as
    ``convert.save_gp_ensemble`` writes it."""
    with np.load(path) as z:
        f = {name: z[name] for name in GPEnsemble._fields}
    return GPEnsemble(
        **{k: np.asarray(v, np.float64) for k, v in f.items()
           if k not in ("n_valid", "out_idx", "feat_idx")},
        n_valid=np.asarray(f["n_valid"], np.int32),
        out_idx=tuple(int(i) for i in f["out_idx"]),
        feat_idx=tuple(int(i) for i in f["feat_idx"]))
