"""The residual dataset of the learned pipeline.

Port of ``ad_mpc_tpu/learned/dataset.py``: regression targets ``y =
(x_out - x_pred) / dt`` (the nominal model's error per second), velocities
rotated into the body frame, pruning by a velocity cap and error
histograms, clustering by a Gaussian mixture (with a cache), soft top-2
cluster agency, train/test splitting and training-point selection. The
Gaussian mixture, k-means and PCA are the port's own
(:mod:`ad_mpc_tpu_torch.learned.cluster`): the JAX package's come from
scikit-learn. The mixture's cache is an ``.npz`` of its arrays in place of
joblib's ``gmm.pkl``. Everything here is host numpy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ad_mpc_tpu_torch.learned.cluster import GaussianMixture, gaussian_mixture, kmeans, pca


def _rot(q):
    """R(q) of quaternions q (m, 4) [w, x, y, z]: (m, 3, 3)."""
    qw, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (qy**2 + qz**2), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)], -1),
        np.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx**2 + qz**2), 2 * (qy * qz - qw * qx)], -1),
        np.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx**2 + qy**2)], -1),
    ], -2)


def world_to_body_velocities(states):
    """(m, 13) quad states with the velocity block rotated into the body
    frame, ``R(q)^T v``."""
    states = np.asarray(states)
    out = states.copy()
    q_inv = states[:, 3:7] * np.array([1.0, -1.0, -1.0, -1.0])
    out[:, 7:10] = np.einsum("mij,mj->mi", _rot(q_inv), states[:, 7:10])
    return out


@dataclass
class ResidualDataset:
    """Recorded (state in, input, nominal error) samples: the regression
    problem of the residual models."""

    x_in: np.ndarray  # (m, nx) states (body-frame velocities)
    u: np.ndarray  # (m, nu)
    y: np.ndarray  # (m, nx) nominal error per second, body frame
    cluster_labels: np.ndarray | None = None
    _gmm: object = field(default=None, repr=False)

    @staticmethod
    def from_rollouts(x_in, u, x_out, x_pred, dt, rotate_body: bool = True):
        """``y = (x_out - x_pred) / dt`` of the rows with dt > 0, the
        velocities of 13-state rows rotated into the body frame."""
        x_in, u, x_out, x_pred = map(np.asarray, (x_in, u, x_out, x_pred))
        dt = np.asarray(dt).reshape(-1)
        keep = dt > 0
        x_in, u, x_out, x_pred, dt = (x_in[keep], u[keep], x_out[keep],
                                      x_pred[keep], dt[keep])
        if rotate_body and x_in.shape[1] == 13:
            x_in, x_out, x_pred = map(world_to_body_velocities, (x_in, x_out, x_pred))
        return ResidualDataset(x_in=x_in, u=u, y=(x_out - x_pred) / dt[:, None])

    def features(self, feat_idx):
        return self.x_in[:, list(feat_idx)]

    def targets(self, dim):
        return self.y[:, dim]

    def prune(self, vel_cap: float = 20.0, hist_bins: int = 10,
              hist_thresh: float = 1e-3, vel_idx=(7, 8, 9)):
        """Drop non-finite rows, rows over the velocity cap, and rows whose
        error falls in a histogram bin holding under ``hist_thresh`` of the
        samples, per output dim and on the error's norm."""
        finite = np.all(np.isfinite(self.x_in), axis=1) & np.all(np.isfinite(self.y), axis=1)
        x_in, u, y = self.x_in[finite], self.u[finite], self.y[finite]
        keep = np.all(np.abs(x_in[:, list(vel_idx)]) <= vel_cap, axis=1)

        def hist_keep(values):
            counts, edges = np.histogram(values, bins=hist_bins)
            frac = counts / max(counts.sum(), 1)
            bin_idx = np.clip(np.digitize(values, edges[:-1]) - 1, 0, hist_bins - 1)
            return frac[bin_idx] >= hist_thresh

        for d in vel_idx:
            keep &= hist_keep(y[:, d])
        keep &= hist_keep(np.linalg.norm(y[:, list(vel_idx)], axis=1))
        return ResidualDataset(x_in=x_in[keep], u=u[keep], y=y[keep])

    def cluster(self, n_clusters: int, feat_idx=(7, 8, 9), seed: int = 0,
                cache_path: str | None = None):
        """Gaussian-mixture clustering in feature space (3 EM starts from
        ``numpy.random.default_rng(seed)``). ``cache_path``: an ``.npz``
        of the mixture, read when it holds ``n_clusters`` components,
        written otherwise (for more than one cluster)."""
        z = self.features(feat_idx)
        gmm = None
        if cache_path is not None and os.path.exists(cache_path):
            cached = GaussianMixture.load(cache_path)
            if cached.n_components == n_clusters:
                gmm = cached
        if gmm is None:
            gmm = gaussian_mixture(z, n_clusters, np.random.default_rng(seed), n_init=3)
            if cache_path is not None and n_clusters > 1:
                os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
                gmm.save(cache_path)
        self._gmm = gmm
        self.cluster_labels = gmm.predict(z)
        return self.cluster_labels

    def cluster_agency(self, feat_idx=(7, 8, 9), top2_thresh: float = 0.2):
        """Soft top-2 assignment: each cluster owns its argmax samples plus
        those whose second-highest membership, for it, exceeds
        ``top2_thresh``. {cluster: sample indices}."""
        if self._gmm is None:
            raise RuntimeError("call cluster() first")
        probs = self._gmm.predict_proba(self.features(feat_idx))
        return agency_of(probs, top2_thresh)

    def cluster_subsets(self, feat_idx=(7, 8, 9)):
        """Yield (cluster, the dataset of its samples)."""
        if self.cluster_labels is None:
            raise RuntimeError("call cluster() first")
        for c in range(self.cluster_labels.max() + 1):
            m = self.cluster_labels == c
            yield c, ResidualDataset(x_in=self.x_in[m], u=self.u[m], y=self.y[m])

    def split(self, test_frac: float = 0.2, seed: int = 0):
        """(train, test) by one permutation of ``default_rng(seed)``."""
        perm = np.random.default_rng(seed).permutation(len(self.x_in))
        n_test = int(len(self.x_in) * test_frac)
        te, tr = perm[:n_test], perm[n_test:]
        return (ResidualDataset(self.x_in[tr], self.u[tr], self.y[tr]),
                ResidualDataset(self.x_in[te], self.u[te], self.y[te]))


def agency_of(probs, top2_thresh: float = 0.2) -> dict:
    """{cluster: indices} of the soft top-2 assignment of the membership
    probabilities ``probs`` (m, C)."""
    idx_aux = np.arange(probs.shape[0])
    top_1 = np.argmax(probs, axis=1)
    probs2 = probs.copy()
    probs2[idx_aux, top_1] = 0.0
    top_2 = np.argmax(probs2, axis=1)
    agency = {}
    for c in range(probs.shape[1]):
        own = np.flatnonzero(top_1 == c)
        soft = np.flatnonzero((top_2 == c) & (probs2[idx_aux, top_2] > top2_thresh))
        agency[c] = np.concatenate([own, soft])
    return agency


def select_training_points(z, y, n_points: int, method: str = "kmeans", seed: int = 0):
    """Indices of at most ``n_points`` training points among the rows of z:

    - ``kmeans``: k-means of the features, the sample nearest each center;
    - ``histogram_median``: a histogram of the first feature with
      ``n_points`` bins, each bin's median sample;
    - ``pca_cuboid``: the samples nearest the center and corners of the
      PCA-aligned bounding cuboid, topped up by inverse-density draws;
    - ``random_inverse_density``: draws in inverse proportion to the
      density of the feature norm's histogram.
    """
    z = np.asarray(z)
    m = len(z)
    if n_points >= m:
        return np.arange(m)
    rng = np.random.default_rng(seed)
    if method == "histogram_median":
        vals = z[:, 0]
        _, edges = np.histogram(vals, bins=n_points)
        bin_idx = np.clip(np.digitize(vals, edges) - 1, 0, n_points - 1)
        idx = []
        for i in range(n_points):
            members = np.flatnonzero(bin_idx == i)
            if len(members) == 0:
                idx.append(int(rng.integers(m)))
                continue
            bin_values = vals[members]
            if len(bin_values) % 2 == 0:  # the median must be a sample
                members, bin_values = members[:-1], bin_values[:-1]
            idx.append(int(members[np.argsort(bin_values)[len(bin_values) // 2]]))
        return np.unique(idx)
    if method == "pca_cuboid":
        d = min(z.shape[1], 3)
        zp = (z - z.mean(axis=0)) @ pca(z, d).components.T
        p_min, p_max = zp.min(axis=0), zp.max(axis=0)
        corners = [np.zeros(d)] + [
            np.array([p_min[j] if (bits >> j) & 1 else p_max[j] for j in range(d)])
            for bits in range(2**d)]
        idx = list(np.unique([int(np.argmin(np.linalg.norm(zp - c, axis=1)))
                              for c in corners[:n_points]]))
        if len(idx) < n_points:
            norm = np.linalg.norm(zp, axis=1)
            counts, edges = np.histogram(norm, bins=20)
            bin_idx = np.clip(np.digitize(norm, edges[:-1]) - 1, 0, 19)
            w = 1.0 / np.maximum(counts[bin_idx], 1)
            w[idx] = 0.0
            fill = rng.choice(m, size=n_points - len(idx), replace=False, p=w / w.sum())
            idx = list(np.unique(np.concatenate([idx, fill])))
        return np.asarray(idx[:n_points])
    if method == "kmeans":
        km = kmeans(z, n_points, rng, n_init=4)
        idx = []
        for c in range(n_points):
            members = np.flatnonzero(km.labels == c)
            if len(members) == 0:
                continue
            d = np.linalg.norm(z[members] - km.centers[c], axis=1)
            idx.append(members[np.argmin(d)])
        return np.unique(idx)
    if method == "random_inverse_density":
        norm = np.linalg.norm(z, axis=1)
        counts, edges = np.histogram(norm, bins=20)
        bin_idx = np.clip(np.digitize(norm, edges[:-1]) - 1, 0, 19)
        w = 1.0 / np.maximum(counts[bin_idx], 1)
        return rng.choice(m, size=n_points, replace=False, p=w / w.sum())
    raise ValueError(method)
