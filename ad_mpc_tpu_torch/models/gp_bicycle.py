"""The GP-augmented dynamic bicycle of bench config c3.

The counterpart of the closure that ``bench.py:216-257`` builds: the
linear-tire bicycle with its blend switch taken from p[0], plus the baked
posterior mean of one cluster of a :class:`GPEnsemble` added to the state
rows ``out_idx`` (v_y and psi_dot), with the features ``x[feat_idx]``
(v_x, v_y, psi_dot, delta).

On the card the ``GPBicycleDyn`` functor of ``csrc/vde_gp_bicycle.cu`` computes the
same function. It takes the cluster's training table by value
(:meth:`GPBicycleDynamics.cuda_params`) in the kernel's parameters, and
each block stages the table in shared memory once, where every lane of a
warp that reads the same entry gets it at once (indexed reads of the
parameters themselves were 10x slower on the RK4 map, ``PERF.md`` section
6), each output dim's X and a four floats past the last dim's
(:func:`gp_table_layout`), since a team of the sweep sums the two dims'
means on two lanes at once. The capacity is :data:`GP_POINTS` points of
:data:`GP_FEATS` features for :data:`GP_DIMS` outputs (1,352 bytes,
inside the 4 KB a kernel's parameters may take).
"""

from __future__ import annotations

import ctypes

import numpy as np
from torch import nn

from ad_mpc_tpu_torch.learned.ensemble import GPEnsemble
from ad_mpc_tpu_torch.learned.lane import add_rows, lane_residual_terms
from ad_mpc_tpu_torch.models.bicycle import (
    BicycleDynamics, BicycleParamsC, bicycle_dynamics)

# Capacity of the functor's table (GP_POINTS, GP_DIMS, GP_FEATS of
# csrc/vde_gp_bicycle.cu) and the layout it serves.
GP_POINTS, GP_DIMS, GP_FEATS = 32, 2, 4
OUT_IDX, FEAT_IDX = (4, 5), (3, 4, 5, 6)


def gp_table_layout() -> dict:
    """Offsets in floats of ``GPBicycleDyn``'s table in shared memory
    (``gp_table`` of ``csrc/vde_gp_bicycle.cu``): {"X": d -> output dim d's
    block of X (GP_POINTS rows of GP_FEATS), "a": d -> its weights,
    "inv_l", "y_mean": the starts of 1/l (GP_DIMS x GP_FEATS) and y_mean,
    "floats": the table's size}. Each dim's X and a block is padded by four
    floats: the two dims' reads of one point lie in distinct banks, and
    every block starts on 16 bytes."""
    x_dim, a_dim = GP_POINTS * GP_FEATS + 4, GP_POINTS + 4
    a0 = GP_DIMS * x_dim
    inv_l = a0 + GP_DIMS * a_dim
    y_mean = inv_l + GP_DIMS * GP_FEATS
    return {"X": lambda d: d * x_dim, "a": lambda d: a0 + d * a_dim,
            "inv_l": inv_l, "y_mean": y_mean, "floats": y_mean + GP_DIMS}


class GPBicycleParamsC(ctypes.Structure):
    """``GPBicycleParamsC`` of ``csrc/vde_gp_bicycle.cu``, passed to the kernel by
    value: the bicycle's scalars, the point count and, per output dim, the
    training features, ``a = k_inv_y sigma_f``, ``1 / length scale`` and
    the target mean, each rounded once to float32."""

    _fields_ = [
        ("bike", BicycleParamsC),
        ("n", ctypes.c_int),
        ("X", ((ctypes.c_float * GP_FEATS) * GP_POINTS) * GP_DIMS),
        ("a", (ctypes.c_float * GP_POINTS) * GP_DIMS),
        ("inv_l", (ctypes.c_float * GP_FEATS) * GP_DIMS),
        ("y_mean", ctypes.c_float * GP_DIMS),
    ]


class GPBicycleDynamics(nn.Module):
    """``f(x, u, p) = bicycle(x, u, switch=p[0])`` with the default
    :class:`BicycleParams`, plus the mean of ``ensemble``'s cluster 0 in
    the rows ``out_idx``.

    ``nx``, ``nu`` and ``p_dim`` state the functor's shape; ``cuda_entry``
    and ``cuda_rk4_entry`` name the C entries of ``csrc/vde_gp_bicycle.cu`` that run
    the VDE kernel and its RK4 kernel with the ``GPBicycleDyn`` functor
    (``cuda_functor``), and ``cuda_params`` builds the struct both take.
    ``cuda_team``: the sweep takes the team entry's launch geometry
    (``ops/cuda_vde.py:vde_geometry``), a team of 1, a thread per row, as
    committed (its teams lost, ``PERF.md``), the table in static shared
    memory.
    """

    nx, nu, p_dim = 7, 2, 1
    cuda_team = True
    cuda_functor = "GPBicycleDyn"
    cuda_source = "vde_gp_bicycle"
    cuda_entry = "vde_gp_bicycle"
    cuda_rk4_entry = "rk4_gp_bicycle"

    def __init__(self, ensemble: GPEnsemble):
        super().__init__()
        self.ensemble = ensemble
        self._struct = None  # built at the first call of cuda_params

    def forward(self, x, u, p):
        base = bicycle_dynamics(x, u, switch=p[0])
        return add_rows(base, lane_residual_terms(self.ensemble, x))

    def cuda_params(self) -> GPBicycleParamsC:
        """The functor's struct (built once: every launch passes it);
        refuses an ensemble the functor does not serve: other
        ``out_idx``/``feat_idx``, or more points, dims or features than its
        capacity."""
        if self._struct is None:
            self._struct = self._params_c()
        return self._struct

    def _params_c(self) -> GPBicycleParamsC:
        ens = self.ensemble
        D, _, n, d = ens.x_train.shape
        if (tuple(ens.out_idx), tuple(ens.feat_idx)) != (OUT_IDX, FEAT_IDX):
            raise ValueError(
                f"the GPBicycleDyn functor serves out_idx={OUT_IDX}, "
                f"feat_idx={FEAT_IDX}; got {ens.out_idx}, {ens.feat_idx}")
        if n > GP_POINTS or D != GP_DIMS or d != GP_FEATS:
            raise ValueError(
                f"the GPBicycleDyn functor holds {GP_POINTS} points of "
                f"{GP_FEATS} features for {GP_DIMS} outputs; got {n} points "
                f"of {d} features for {D} outputs")
        s = GPBicycleParamsC()
        s.bike = BicycleDynamics().cuda_params()
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
