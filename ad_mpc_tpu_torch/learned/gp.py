"""Exact Gaussian-process regression: the kernel and the posterior mean.

Port of ``ad_mpc_tpu/learned/gp.py``: the anisotropic squared-
exponential kernel, the posterior mean from the cached ``K^-1 y``, the
posterior variance, and the hyperparameter fit: scipy's L-BFGS-B with
restarts on the negative log marginal likelihood (:func:`_nll`), whose
gradient comes from ``torch.autograd`` in float64 (the JAX package's
``jax.value_and_grad``). The fit is host work on the CPU: its matrices
are the training set's, some 60 x 60.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from scipy.optimize import minimize


class GPParams(NamedTuple):
    """Precomputed exact-GP state; arrays (numpy or tensors) and floats."""

    x_train: object  # (n, d)
    k_inv_y: object  # (n,)  = K^-1 (y - y_mean)
    len_scale: object  # (d,)
    sigma_f: float  # amplitude
    sigma_n: float  # noise std
    y_mean: float  # training-target mean
    centroid: object  # (d,) training-feature mean (ensemble selection)


def kernel(x1, x2, len_scale, sigma_f):
    """Anisotropic SE kernel matrix (m,d),(n,d) -> (m,n):
    ``k = sigma_f exp(-0.5 ||(x - x') / l||^2)``."""
    d = (x1[:, None, :] - x2[None, :, :]) / len_scale
    return sigma_f * torch.exp(-0.5 * torch.sum(d * d, dim=-1))


def kernel_vec(z, x_train, len_scale, sigma_f):
    """k(z, X): (d,),(n,d) -> (n,)."""
    d = (z[None, :] - x_train) / len_scale
    return sigma_f * torch.exp(-0.5 * torch.sum(d * d, dim=-1))


def predict_mean(params: GPParams, z):
    """Posterior mean at one query point z (d,): ``k_s . K^-1 y + y_mean``,
    with the parameters as tensors of z's type."""
    as_t = lambda a: torch.as_tensor(a, dtype=z.dtype, device=z.device)
    k_s = kernel_vec(z, as_t(params.x_train), as_t(params.len_scale),
                     float(params.sigma_f))
    return torch.dot(k_s, as_t(params.k_inv_y)) + float(params.y_mean)


def predict_var(params: GPParams, z):
    """Posterior variance at one query point z (d,):
    ``sigma_f - k_s . (K + (sigma_n^2 + 1e-8) I)^-1 k_s``."""
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=z.dtype, device=z.device)
    X, ls, sf = as_t(params.x_train), as_t(params.len_scale), float(params.sigma_f)
    k_s = kernel_vec(z, X, ls, sf)
    K = kernel(X, X, ls, sf)
    K = K + (float(params.sigma_n) ** 2 + 1e-8) * torch.eye(
        K.shape[0], dtype=z.dtype, device=z.device)
    sol = torch.linalg.solve(K, k_s)
    return sf - torch.dot(k_s, sol)


def _nll(theta, x, y):
    """Negative log marginal likelihood over the log-hyperparameters
    ``theta = [log l (d), log sigma_f, log sigma_n]``, tensors of one
    dtype. A kernel matrix that is not positive definite gives NaN (as
    JAX's Cholesky does), not an exception."""
    d = x.shape[1]
    len_scale = torch.exp(theta[:d])
    sigma_f = torch.exp(theta[d])
    sigma_n = torch.exp(theta[d + 1])
    K = kernel(x, x, len_scale, sigma_f)
    K = K + (sigma_n**2 + 1e-8) * torch.eye(x.shape[0], dtype=x.dtype)
    L, info = torch.linalg.cholesky_ex(K)
    if int(info) != 0:
        L = L * float("nan")
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    return (torch.sum(torch.log(torch.diagonal(L))) + 0.5 * torch.dot(y, alpha)
            + 0.5 * x.shape[0] * math.log(2 * math.pi))


def _restarts(obj, x, yc, d, rng, n_restarts, log_bounds):
    """The best (theta, NLL) of ``n_restarts`` L-BFGS-B runs of ``obj``,
    each from the JAX package's draws of ``rng``."""
    best, best_val = None, np.inf
    for _ in range(n_restarts):
        theta0 = np.concatenate([
            np.log(x.std(axis=0) + 1e-3) + rng.normal(0, 0.5, d),
            [np.log(yc.std() + 1e-3) + rng.normal(0, 0.5)],
            [np.log(0.1 * (yc.std() + 1e-3)) + rng.normal(0, 0.5)],
        ])
        res = minimize(obj, theta0, jac=True, method="L-BFGS-B",
                       bounds=[log_bounds] * (d + 2))
        if res.fun < best_val:
            best, best_val = res.x, res.fun
    return best, best_val


def fit_gp(x_train, y_train, n_restarts: int = 5, seed: int = 0,
           log_bounds=(-7.0, 7.0)) -> GPParams:
    """Fit the hyperparameters by ``n_restarts`` runs of L-BFGS-B on
    :func:`_nll` within ``log_bounds``, each from the draws of
    ``numpy.random.default_rng(seed)`` that the JAX package makes, and
    precompute ``K^-1 (y - y_mean)``. Returns float64 numpy parameters."""
    x = np.asarray(x_train, dtype=np.float64)
    y = np.asarray(y_train, dtype=np.float64).reshape(-1)
    y_mean = y.mean()
    yc = y - y_mean
    d = x.shape[1]
    xt, yt = torch.as_tensor(x), torch.as_tensor(yc)

    def obj(theta):
        t = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
        v = _nll(t, xt, yt)
        (g,) = torch.autograd.grad(v, t)
        return float(v.detach()), g.numpy()

    # The matrices are small: one thread runs the fit some 20x faster than
    # torch's pool (0.09 s against 2.1 s for 60 points and 3 restarts on an
    # 8-core x86 host).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        best, _ = _restarts(obj, x, yc, d, np.random.default_rng(seed), n_restarts,
                            log_bounds)
    finally:
        torch.set_num_threads(threads)
    if best is None:
        raise RuntimeError("all hyperparameter fits failed")

    len_scale = np.exp(best[:d])
    sigma_f = float(np.exp(best[d]))
    sigma_n = float(np.exp(best[d + 1]))
    K = kernel(xt, xt, torch.as_tensor(len_scale), sigma_f).numpy()
    K = K + (sigma_n**2 + 1e-8) * np.eye(len(x))
    k_inv_y = np.linalg.solve(K, yc)
    return GPParams(x_train=x, k_inv_y=k_inv_y, len_scale=len_scale,
                    sigma_f=sigma_f, sigma_n=sigma_n, y_mean=float(y_mean),
                    centroid=x.mean(axis=0))
