"""The GP-augmented quadrotor of bench config c6.

The counterpart of the dynamics closure that
``ad_mpc_tpu/experiments/quad_fleet.py:110-121`` builds from an ensemble:
the entrywise quad (:func:`quad_dynamics_lane`) plus the body-frame GP
residual of cluster 0, ``x_dot[7:10] += R(q) GP(R(q)^T v)``
(:func:`quad_lane_residual_terms`), with features and outputs on the
velocity rows (7, 8, 9).

On the card the ``GPQuadDyn`` functor of ``csrc/vde.cu`` computes the same
function. It takes the cluster's training table by value
(:meth:`GPQuadDynamics.cuda_params`) in the kernel's parameters, and each
block stages the table in shared memory once. The capacity is
:data:`GP_QUAD_POINTS` points of 3 features for 3 outputs (3,208 bytes,
inside the 4 KB a kernel's parameters may take): the bench's synthetic 32
points and the fitted ``gp_flagship_c1`` model's 60.
"""

from __future__ import annotations

import ctypes

import numpy as np
from torch import nn

from ad_mpc_tpu_torch.learned.ensemble import GPEnsemble
from ad_mpc_tpu_torch.learned.lane import add_rows, quad_lane_residual_terms
from ad_mpc_tpu_torch.models.quadrotor import (
    NU, NX, QuadDynamics, QuadParamsC, QuadrotorParams, quad_dynamics_lane)

# Capacity of the functor's table (GP_QUAD_POINTS, GP_QUAD_DIMS,
# GP_QUAD_FEATS of csrc/vde.cu) and the layout it serves.
GP_QUAD_POINTS, GP_QUAD_DIMS, GP_QUAD_FEATS = 64, 3, 3
OUT_IDX = FEAT_IDX = (7, 8, 9)


class GPQuadParamsC(ctypes.Structure):
    """``GPQuadParamsC`` of ``csrc/vde.cu``, passed to the kernel by value:
    the quad's scalars, the point count and, per output dim, the training
    features, ``a = k_inv_y sigma_f``, ``1 / length scale`` and the target
    mean, each rounded once to float32."""

    _fields_ = [
        ("quad", QuadParamsC),
        ("n", ctypes.c_int),
        ("X", ((ctypes.c_float * GP_QUAD_FEATS) * GP_QUAD_POINTS) * GP_QUAD_DIMS),
        ("a", (ctypes.c_float * GP_QUAD_POINTS) * GP_QUAD_DIMS),
        ("inv_l", (ctypes.c_float * GP_QUAD_FEATS) * GP_QUAD_DIMS),
        ("y_mean", ctypes.c_float * GP_QUAD_DIMS),
    ]


class GPQuadDynamics(nn.Module):
    """``f(x, u, p) = quad_dynamics_lane(x, u, params)`` plus
    ``ensemble``'s cluster-0 body-frame residual in the velocity rows;
    ``p`` is ignored (``p_dim=0``).

    ``nx``, ``nu`` and ``p_dim`` state the functor's shape; ``cuda_entry``
    and ``cuda_rk4_entry`` name the C entries of ``csrc/vde.cu`` that run
    the VDE kernel and its RK4 kernel with the ``GPQuadDyn`` functor
    (``cuda_functor``), and ``cuda_params`` builds the struct both take.
    """

    nx, nu, p_dim = NX, NU, 0
    cuda_functor = "GPQuadDyn"
    cuda_entry = "vde_gp_quad"
    cuda_rk4_entry = "rk4_gp_quad"

    def __init__(self, ensemble: GPEnsemble,
                 params: QuadrotorParams = QuadrotorParams()):
        super().__init__()
        self.ensemble = ensemble
        self.params = params
        self._struct = None  # built at the first call of cuda_params

    def forward(self, x, u, p):
        base = quad_dynamics_lane(x, u, None, self.params)
        return add_rows(base, quad_lane_residual_terms(self.ensemble, x))

    def cuda_params(self) -> GPQuadParamsC:
        """The functor's struct (built once: every launch passes it);
        refuses an ensemble the functor does not serve: other
        ``out_idx``/``feat_idx``, or more points, dims or features than its
        capacity."""
        if self._struct is None:
            self._struct = self._params_c()
        return self._struct

    def _params_c(self) -> GPQuadParamsC:
        ens = self.ensemble
        D, _, n, d = ens.x_train.shape
        if (tuple(ens.out_idx), tuple(ens.feat_idx)) != (OUT_IDX, FEAT_IDX):
            raise ValueError(
                f"the GPQuadDyn functor serves out_idx = feat_idx = {OUT_IDX}; "
                f"got {ens.out_idx}, {ens.feat_idx}")
        if n > GP_QUAD_POINTS or D != GP_QUAD_DIMS or d != GP_QUAD_FEATS:
            raise ValueError(
                f"the GPQuadDyn functor holds {GP_QUAD_POINTS} points of "
                f"{GP_QUAD_FEATS} features for {GP_QUAD_DIMS} outputs; got {n} "
                f"points of {d} features for {D} outputs")
        s = GPQuadParamsC()
        s.quad = QuadDynamics(self.params).cuda_params()
        s.n = n
        for k in range(D):
            X = np.asarray(ens.x_train[k, 0], np.float64)
            a = np.asarray(ens.k_inv_y[k, 0], np.float64) * float(ens.sigma_f[k, 0])
            inv_l = 1.0 / np.asarray(ens.len_scale[k, 0], np.float64)
            for j in range(n):
                s.X[k][j][:] = [float(v) for v in X[j]]
                s.a[k][j] = float(a[j])
            s.inv_l[k][:] = [float(v) for v in inv_l]
            s.y_mean[k] = float(ens.y_mean[k, 0])
        return s
