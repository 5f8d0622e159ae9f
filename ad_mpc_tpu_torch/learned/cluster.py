"""K-means, a Gaussian mixture and PCA, in numpy: the clustering the
learned pipeline needs.

The JAX package clusters and sub-selects its residual dataset with
scikit-learn (``ad_mpc_tpu/learned/dataset.py:106, 209, 240``:
``GaussianMixture``, ``PCA``, ``KMeans``). The port runs where
scikit-learn is not installed, so it keeps its own of each, with the same
defaults: k-means with k-means++ seeding (2 + log k local trials) and
``n_init`` Lloyd restarts, keeping the least inertia; a full-covariance
Gaussian mixture fitted by EM from a k-means partition (``reg_covar``
1e-6 on the diagonal, ``tol`` 1e-3 on the mean log-likelihood, at most
100 iterations, the best of ``n_init`` starts); PCA by the SVD of the
centred data, each component's largest entry made positive. Each takes an
explicit ``numpy.random.Generator``. They cannot draw scikit-learn's
random numbers, so a fit from the same seed is not scikit-learn's bit for
bit: on well-separated data it gives the same partition (up to the
clusters' order) and the same selections.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def _sq_dists(X, C):
    """(n, k) squared distances of the rows of X to the rows of C."""
    return np.maximum((X * X).sum(1)[:, None] - 2.0 * X @ C.T + (C * C).sum(1)[None, :],
                      0.0)


def kmeans_plusplus(X, k: int, rng: np.random.Generator):
    """k initial centers by greedy k-means++: each new center the best of
    2 + int(log k) candidates drawn in proportion to the squared distance
    to the nearest center so far."""
    n = X.shape[0]
    trials = 2 + int(np.log(k))
    centers = np.empty((k, X.shape[1]))
    centers[0] = X[rng.integers(n)]
    closest = _sq_dists(X, centers[:1])[:, 0]
    pot = closest.sum()
    for c in range(1, k):
        if pot <= 0.0:
            cand = rng.integers(n, size=trials)
        else:
            cum = np.cumsum(closest)
            cand = np.minimum(np.searchsorted(cum, rng.uniform(size=trials) * pot), n - 1)
        d = np.minimum(closest[None, :], _sq_dists(X, X[cand]).T)
        best = int(np.argmin(d.sum(1)))
        closest, pot = d[best], d[best].sum()
        centers[c] = X[cand[best]]
    return centers


class KMeans(NamedTuple):
    """A fitted k-means: ``centers`` (k, d), ``labels`` (n,), ``inertia``."""

    centers: np.ndarray
    labels: np.ndarray
    inertia: float

    def predict(self, X):
        return np.argmin(_sq_dists(np.asarray(X, float), self.centers), axis=1)


def _lloyd(X, centers, max_iter: int, tol: float):
    for _ in range(max_iter):
        labels = np.argmin(_sq_dists(X, centers), axis=1)
        new = centers.copy()
        for c in range(len(centers)):
            m = labels == c
            if m.any():
                new[c] = X[m].mean(0)
        shift = ((new - centers) ** 2).sum()
        centers = new
        if shift <= tol:
            break
    d = _sq_dists(X, centers)
    labels = np.argmin(d, axis=1)
    return centers, labels, float(d[np.arange(len(X)), labels].sum())


def kmeans(X, k: int, rng: np.random.Generator, n_init: int = 4,
           max_iter: int = 300, tol: float = 1e-4) -> KMeans:
    """K-means of the rows of X into k clusters: ``n_init`` k-means++
    starts, Lloyd iterations until the centers move by at most ``tol``
    times the data's mean variance; the start of least inertia."""
    X = np.asarray(X, float)
    tol_abs = tol * float(np.mean(np.var(X, axis=0)))
    best = None
    for _ in range(n_init):
        c, lab, inertia = _lloyd(X, kmeans_plusplus(X, k, rng), max_iter, tol_abs)
        if best is None or inertia < best.inertia:
            best = KMeans(c, lab, inertia)
    return best


class GaussianMixture(NamedTuple):
    """A fitted full-covariance Gaussian mixture: ``weights`` (k,),
    ``means`` (k, d), ``covariances`` (k, d, d)."""

    weights: np.ndarray
    means: np.ndarray
    covariances: np.ndarray

    @property
    def n_components(self) -> int:
        return len(self.weights)

    def _weighted_log_prob(self, X):
        X = np.asarray(X, float)
        n, d = X.shape
        out = np.empty((n, self.n_components))
        for c in range(self.n_components):
            L = np.linalg.cholesky(self.covariances[c])
            y = np.linalg.solve(L, (X - self.means[c]).T)
            out[:, c] = (-0.5 * (d * np.log(2 * np.pi) + (y * y).sum(0))
                         - np.log(np.diag(L)).sum() + np.log(self.weights[c]))
        return out

    def _log_resp(self, X):
        w = self._weighted_log_prob(X)
        norm = np.logaddexp.reduce(w, axis=1)
        return w - norm[:, None], float(norm.mean())

    def predict(self, X):
        return np.argmax(self._weighted_log_prob(X), axis=1)

    def predict_proba(self, X):
        return np.exp(self._log_resp(X)[0])

    def save(self, path):
        np.savez(path, weights=self.weights, means=self.means,
                 covariances=self.covariances)

    @staticmethod
    def load(path) -> "GaussianMixture":
        with np.load(path) as z:
            return GaussianMixture(z["weights"], z["means"], z["covariances"])


def _m_step(X, resp, reg_covar):
    n, d = X.shape
    nk = resp.sum(0) + 10 * np.finfo(float).eps
    means = resp.T @ X / nk[:, None]
    cov = np.empty((len(nk), d, d))
    for c in range(len(nk)):
        diff = X - means[c]
        cov[c] = (resp[:, c] * diff.T) @ diff / nk[c]
        cov[c].flat[:: d + 1] += reg_covar
    return GaussianMixture(nk / n, means, cov)


def gaussian_mixture(X, k: int, rng: np.random.Generator, n_init: int = 3,
                     max_iter: int = 100, tol: float = 1e-3,
                     reg_covar: float = 1e-6) -> GaussianMixture:
    """EM fit of a k-component full-covariance mixture to the rows of X,
    each of ``n_init`` starts from a one-start k-means partition; the start
    of the highest mean log-likelihood."""
    X = np.asarray(X, float)
    best, best_lb = None, -np.inf
    for _ in range(n_init):
        lab = kmeans(X, k, rng, n_init=1).labels
        resp = np.zeros((len(X), k))
        resp[np.arange(len(X)), lab] = 1.0
        gmm = _m_step(X, resp, reg_covar)
        lb = -np.inf
        for _ in range(max_iter):
            log_resp, new_lb = gmm._log_resp(X)
            gmm = _m_step(X, np.exp(log_resp), reg_covar)
            done = abs(new_lb - lb) < tol
            lb = new_lb
            if done:
                break
        if lb > best_lb or best is None:
            best, best_lb = gmm, lb
    return best


class PCA(NamedTuple):
    """Principal axes: ``mean`` (d,), ``components`` (k, d), rows of unit
    norm, each with its largest entry positive."""

    mean: np.ndarray
    components: np.ndarray


def pca(X, n_components: int) -> PCA:
    """The first ``n_components`` principal axes of the rows of X."""
    X = np.asarray(X, float)
    mean = X.mean(0)
    _, _, Vt = np.linalg.svd(X - mean, full_matrices=False)
    Vt = Vt[:n_components]
    signs = np.sign(Vt[np.arange(len(Vt)), np.argmax(np.abs(Vt), axis=1)])
    return PCA(mean, Vt * signs[:, None])
