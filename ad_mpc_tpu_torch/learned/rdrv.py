"""The RDRv linear drag model (port of ``ad_mpc_tpu/learned/rdrv.py``):
per body axis, the least-squares slope (no intercept) of the acceleration
error against the body-frame velocity, a diagonal 3x3 drag matrix D that
the quad adds as ``v_dot += R(q) D R(q)^T v``."""

from __future__ import annotations

import numpy as np

from ad_mpc_tpu_torch.learned.dataset import ResidualDataset


def fit_rdrv(dataset: ResidualDataset, vel_idx=(7, 8, 9)) -> np.ndarray:
    """The (3, 3) diagonal drag matrix D."""
    v = dataset.x_in[:, list(vel_idx)]
    a_err = dataset.y[:, list(vel_idx)]
    d = np.zeros(3)
    for i in range(3):
        denom = float(v[:, i] @ v[:, i])
        d[i] = float(v[:, i] @ a_err[:, i]) / denom if denom > 0 else 0.0
    return np.diag(d)
