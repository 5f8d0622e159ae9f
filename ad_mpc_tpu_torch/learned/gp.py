"""Exact Gaussian-process regression: the kernel and the posterior mean.

Port of ``ad_mpc_tpu/learned/gp.py:31-71``: the anisotropic squared-
exponential kernel and the posterior mean from the cached ``K^-1 y``. The
hyperparameter fit (``fit_gp``) and the posterior variance
(``predict_var``) are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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
