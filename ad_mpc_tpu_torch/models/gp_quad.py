"""The GP-augmented quadrotors: bench config c6, QuadMPC's dual-state GP
(:class:`GPQuadDualDynamics`) and its clustered ``quad_residual_fn``
(:class:`GPQuadSelectDynamics`), the last two with the RDRv drag where
asked (below).

The counterpart of the dynamics closure that
``ad_mpc_tpu/experiments/quad_fleet.py:110-121`` builds from an ensemble:
the entrywise quad (:func:`quad_dynamics_lane`) plus the body-frame GP
residual of cluster 0, ``x_dot[7:10] += R(q) GP(R(q)^T v)``
(:func:`quad_lane_residual_terms`), with features and outputs on the
velocity rows (7, 8, 9).

On the card the ``GPQuadDyn`` functor of ``csrc/vde_gp_quad.cu`` computes the same
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
import torch
from torch import nn

from ad_mpc_tpu_torch.learned.ensemble import GPEnsemble
from ad_mpc_tpu_torch.learned.lane import (
    _ens_cluster, _rot_rows, add_rows, lane_gp_mean, quad_lane_residual_terms,
    quad_select_residual_terms)
from ad_mpc_tpu_torch.models.quadrotor import (
    NU, NX, QuadDynamics, QuadParamsC, QuadrotorParams, drag_matrix,
    quad_drag_rows, quad_dynamics_lane)
from ad_mpc_tpu_torch.ops import _build

# Capacity of the functor's table (GP_QUAD_POINTS, GP_QUAD_DIMS,
# GP_QUAD_FEATS of csrc/vde_gp_quad.cu) and the layout it serves.
GP_QUAD_POINTS, GP_QUAD_DIMS, GP_QUAD_FEATS = 64, 3, 3
OUT_IDX = FEAT_IDX = (7, 8, 9)


class GPQuadParamsC(ctypes.Structure):
    """``GPQuadParamsC`` of ``csrc/vde_gp_quad.cu``, passed to the kernel by value:
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
    and ``cuda_rk4_entry`` name the C entries of ``csrc/vde_gp_quad.cu`` that run
    the VDE kernel and its RK4 kernel with the ``GPQuadDyn`` functor
    (``cuda_functor``), and ``cuda_params`` builds the struct both take.
    ``cuda_team``: the sweep runs a team of lanes per row
    (``ops/cuda_vde.py:vde_geometry``).
    """

    nx, nu, p_dim = NX, NU, 0
    cuda_team = True
    cuda_functor = "GPQuadDyn"
    cuda_source = "vde_gp_quad"
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


# Capacity of the tables of GPQuadDualDyn and GPQuadSelectDyn
# (GP_DUAL_CLUSTERS, GP_DUAL_POINTS of csrc/vde_models.cuh): clusters, and
# clusters x points per output dim.
GP_DUAL_CLUSTERS, GP_DUAL_POINTS = 16, 512
BODY_VELOCITIES = (7, 8, 9)
SMEM_BANKS = 32
# Floats of the largest tables (GP_DUAL_TABLE_MAX, GP_SELECT_TABLE_MAX of
# csrc/): at most 31 floats of padding per (output, cluster) block of X
# and of a (gp_dual_layout), and the select functor's centroids.
GP_DUAL_TABLE_MAX = 3 * (4 * GP_DUAL_POINTS + 66 * GP_DUAL_CLUSTERS)
GP_SELECT_TABLE_MAX = GP_DUAL_TABLE_MAX + 9 * GP_DUAL_CLUSTERS + 3


def bank_pad(m: int) -> int:
    """``m`` floats padded to the least count that is 1 modulo the 32 banks
    of shared memory (``csrc/vde_models.cuh:bank_pad``)."""
    return m + (SMEM_BANKS + 1 - m % SMEM_BANKS) % SMEM_BANKS


def gp_dual_layout(C: int, n: int) -> dict:
    """Offsets in floats of the table of ``C`` clusters of ``n`` points
    (``csrc/vde_models.cuh:GPDualTable``): {"X": (d, c) -> block of X, "a":
    (d, c) -> block of a, "inv_l", "y_mean", "centroids": d -> start,
    "floats": the dual functor's floats, "select_floats": the select
    functor's, with the centroids}. Each (output d, cluster c) block of X
    (3n floats) and of a (n) is padded to :func:`bank_pad`, so that the 3C
    blocks start in distinct banks (C <= 10)."""
    xb, ab = bank_pad(3 * n), bank_pad(n)
    a0 = 3 * C * xb
    inv_l0 = a0 + 3 * C * ab
    y0 = inv_l0 + 9 * C
    cen0 = y0 + 3 * C
    return {"X": lambda d, c: (d * C + c) * xb,
            "a": lambda d, c: a0 + (d * C + c) * ab,
            "inv_l": lambda d, c: inv_l0 + (d * C + c) * 3,
            "y_mean": lambda d, c: y0 + d * C + c,
            "centroids": lambda d: cen0 + d * (3 * C + 1),
            "floats": cen0, "select_floats": cen0 + 3 * (3 * C + 1)}


def gp_quad_table(ens: GPEnsemble, functor: str, centroids: bool = False) -> np.ndarray:
    """The padded table of every cluster that the ``functor`` (the
    ``GPQuadDualDyn`` or ``GPQuadSelectDyn`` of ``csrc/``) stages, as
    float32 numpy, laid out by :func:`gp_dual_layout`: X (3, C, n, 3), a =
    k_inv_y sigma_f (3, C, n), 1/l (3, C, 3), y_mean (3, C), by body
    velocity; zeros on the outputs and features that the ensemble does not
    have, and in the padding. With ``centroids``, then the centroids
    (3, C, 3), each output's in the ensemble's feature order. Refuses a
    layout the functor cannot hold."""
    D, C, n, d = ens.x_train.shape
    out, feat = tuple(ens.out_idx), tuple(ens.feat_idx)
    body = set(BODY_VELOCITIES)
    if (not set(out) <= body or not set(feat) <= body
            or len(set(out)) != D or len(set(feat)) != d):
        raise ValueError(
            f"the {functor} functor serves distinct out_idx and "
            f"feat_idx within {BODY_VELOCITIES}; got out_idx={out}, "
            f"feat_idx={feat}")
    if C > GP_DUAL_CLUSTERS or C * n > GP_DUAL_POINTS:
        raise ValueError(
            f"the {functor} functor holds {GP_DUAL_CLUSTERS} clusters "
            f"and {GP_DUAL_POINTS} points per output over all clusters; "
            f"got {C} clusters of {n} points ({C * n})")
    X = np.zeros((3, C, n, 3))
    a = np.zeros((3, C, n))
    inv_l = np.zeros((3, C, 3))
    y_mean = np.zeros((3, C))
    cen = np.zeros((3, C, 3))
    cols = [dim - 7 for dim in feat]
    for k, dim in enumerate(out):
        r = dim - 7
        X[r][..., cols] = ens.x_train[k]
        a[r] = ens.k_inv_y[k] * ens.sigma_f[k][:, None]
        inv_l[r][..., cols] = 1.0 / ens.len_scale[k]
        y_mean[r] = ens.y_mean[k]
        cen[r][..., :d] = ens.centroids[k]
    lay = gp_dual_layout(C, n)
    out = np.zeros(lay["select_floats" if centroids else "floats"], np.float32)
    for r in range(3):
        for c in range(C):
            out[lay["X"](r, c):][:3 * n] = X[r, c].ravel()
            out[lay["a"](r, c):][:n] = a[r, c]
            out[lay["inv_l"](r, c):][:3] = inv_l[r, c]
            out[lay["y_mean"](r, c)] = y_mean[r, c]
        if centroids:
            out[lay["centroids"](r):][:3 * C] = cen[r].ravel()
    return out


class QuadDragOptC(ctypes.Structure):
    """``QuadDragOptC`` of ``csrc/vde_models.cuh``: the RDRv drag beside a GP
    quad's residual, on or off, and D, row-major, rounded once to float32."""

    _fields_ = [("on", ctypes.c_int), ("D", (ctypes.c_float * 3) * 3)]


class GPQuadDualParamsC(ctypes.Structure):
    """``GPQuadDualParamsC`` of ``csrc/vde_gp_quad_dual.cu``, passed to the kernel by
    value: the quad's scalars, the device address of the padded table
    (:func:`gp_quad_table`), its clusters and points per cluster, the
    ensemble's D, per body velocity its output's place in p (or -1), and
    the drag."""

    _fields_ = [
        ("quad", QuadParamsC),
        ("table", ctypes.c_void_p),
        ("clusters", ctypes.c_int),
        ("n", ctypes.c_int),
        ("d_out", ctypes.c_int),
        ("slot", ctypes.c_int * 3),
        ("drag", QuadDragOptC),
    ]


class GPQuadSelectParamsC(ctypes.Structure):
    """``GPQuadSelectParamsC`` of ``csrc/vde_gp_quad_select.cu``, passed to the
    kernel by value: the quad's scalars, the device address of the padded
    table with the centroids, its clusters and points per cluster, the
    ensemble's features (d, and the body velocity of each), per body
    velocity its pinned cluster (or -1: the nearest centroid), and the
    drag."""

    _fields_ = [
        ("quad", QuadParamsC),
        ("table", ctypes.c_void_p),
        ("clusters", ctypes.c_int),
        ("n", ctypes.c_int),
        ("d_feat", ctypes.c_int),
        ("feat", ctypes.c_int * 3),
        ("pin", ctypes.c_int * 3),
        ("drag", QuadDragOptC),
    ]


def dual_gp_rows(ens: GPEnsemble, x, p, mean=lane_gp_mean) -> dict:
    """The dual-state GP residual of QuadMPC's ensemble mode
    (``ad_mpc_tpu/control/mpc.py:264-283``), entrywise, by velocity row.

    ``p = [trigger, mu0 (D), cluster (D)]`` (entries leading): where
    ``p[0] > 0.5`` the body-frame means are the constants mu0, else each
    output k's mean is its cluster's (``p[1+D+k]`` truncated, clamped to
    the ensemble) lane mean (``mean``, :func:`lane.lane_gp_mean`) at the
    body-frame features (``x`` with its velocities rotated, ``R(q)^T v``).
    The means, with zeros on the body velocities that are no output, are
    rotated back, ``{7 + r: (R(q) mu)_r}``."""
    D, C = len(ens.out_idx), ens.n_clusters
    R = _rot_rows(x)
    v_b = [R[0][k] * x[7] + R[1][k] * x[8] + R[2][k] * x[9] for k in range(3)]
    z = [v_b[i - 7] if i in BODY_VELOCITIES else x[i] for i in ens.feat_idx]
    trigger = p[0] > 0.5
    mu = [torch.zeros_like(x[7])] * 3
    for k, dim in enumerate(ens.out_idx):
        means = [mean(*_ens_cluster(ens, k, c), z) for c in range(C)]
        m = means[0]
        if C > 1:
            cl = torch.clamp(p[1 + D + k].to(torch.int64), 0, C - 1)
            for c in range(1, C):
                m = torch.where(cl == c, means[c], m)
        mu[dim - 7] = torch.where(trigger, p[1 + k], m)
    return {7 + r: R[r][0] * mu[0] + R[r][1] * mu[1] + R[r][2] * mu[2]
            for r in range(3)}


def pinned_clusters(ens: GPEnsemble, fixed_cluster):
    """None, or each output's cluster (D,) from ``quad_residual_fn``'s
    ``fixed_cluster`` (an int or D ints): a negative index counted from the
    last cluster and the rest clamped to the ensemble, as a JAX gather
    takes them."""
    if fixed_cluster is None:
        return None
    C = ens.n_clusters
    c = np.broadcast_to(np.asarray(fixed_cluster, np.int64), (len(ens.out_idx),))
    return tuple(int(v) for v in np.clip(np.where(c < 0, c + C, c), 0, C - 1))


class _ClusterTableDynamics(nn.Module):
    """A GP quad whose functor stages a table of every cluster
    (:func:`gp_quad_table`) from a device buffer: the quad, the RDRv drag
    ``rdrv_d`` where given, and a residual; the struct
    (:meth:`cuda_params`) holds the quad, the table's address (the module
    keeps the copy on the card) and the drag, and a subclass's layout
    (:meth:`_layout`). ``cuda_team``: the sweep runs a team of lanes per
    row (``ops/cuda_vde.py:vde_geometry``), the table after the block's
    tile."""

    nx, nu = NX, NU
    cuda_team = True

    def __init__(self, ensemble: GPEnsemble, params: QuadrotorParams, rdrv_d):
        super().__init__()
        self.ensemble = ensemble
        self.params = params
        self.D = None if rdrv_d is None else drag_matrix(rdrv_d)
        self._device_table = None  # (tensor, struct), built at first use

    def _nominal(self, x, u):
        """The quad, plus the drag rows where there is a drag."""
        base = quad_dynamics_lane(x, u, None, self.params)
        return base if self.D is None else add_rows(base, quad_drag_rows(x, self.D))

    def cuda_params(self):
        """The functor's struct, with the table copied once to the current
        CUDA device; the layout is checked before the card is asked for."""
        if self._device_table is None:
            flat = self.cuda_table()
            _build.require_card("cuda")
            table = torch.as_tensor(
                flat, device=torch.device("cuda", torch.cuda.current_device()))
            s = self._layout()
            s.quad = QuadDynamics(self.params).cuda_params()
            s.table = table.data_ptr()
            s.drag.on = int(self.D is not None)
            if self.D is not None:
                for r in range(3):
                    s.drag.D[r][:] = self.D[r]
            self._device_table = (table, s)
        return self._device_table[1]


class GPQuadDualDynamics(_ClusterTableDynamics):
    """``f(x, u, p)``: the quad (:func:`quad_dynamics_lane`), plus the RDRv
    drag (``rdrv_d``, :func:`quad_drag_rows`) where given, plus the
    dual-state GP residual (:func:`dual_gp_rows`) of ``ensemble``, with
    ``p_dim = 1 + 2D``: the dynamics of QuadMPC's ensemble mode.

    On the card the ``GPQuadDualDyn`` functor of ``csrc/vde_gp_quad_dual.cu``
    computes the same function (``cuda_entry``, ``cuda_rk4_entry``; with
    the drag ``GPQuadDualDragDyn``, the same template with the drag on, of
    ``csrc/vde_gp_quad_dual_drag.cu``; both in ``vde_gp_quad_dual.cuh``). Its
    table (:meth:`cuda_table`) lies in a device buffer whose address rides
    in the struct (:meth:`cuda_params`): every cluster, padded to the three
    body velocities as outputs and features. It serves ``out_idx`` and
    ``feat_idx`` within (7, 8, 9), up to :data:`GP_DUAL_CLUSTERS` clusters
    and :data:`GP_DUAL_POINTS` points per output over all clusters.
    """

    cuda_functor = "GPQuadDualDyn"
    cuda_source = "vde_gp_quad_dual"
    cuda_entry = "vde_gp_quad_dual"
    cuda_rk4_entry = "rk4_gp_quad_dual"

    def __init__(self, ensemble: GPEnsemble,
                 params: QuadrotorParams = QuadrotorParams(), rdrv_d=None):
        super().__init__(ensemble, params, rdrv_d)
        self.p_dim = 1 + 2 * len(ensemble.out_idx)
        if self.D is not None:  # the drag's instantiation, in a source of its own
            self.cuda_functor = "GPQuadDualDragDyn"
            self.cuda_source = self.cuda_entry = "vde_gp_quad_dual_drag"
            self.cuda_rk4_entry = "rk4_gp_quad_dual_drag"

    def with_ensemble(self, ensemble: GPEnsemble) -> "GPQuadDualDynamics":
        return GPQuadDualDynamics(ensemble, self.params, self.D)

    def forward(self, x, u, p):
        return add_rows(self._nominal(x, u), dual_gp_rows(self.ensemble, x, p))

    def cuda_table(self) -> np.ndarray:
        return gp_quad_table(self.ensemble, self.cuda_functor)

    def cuda_layout(self) -> tuple:
        """(clusters, points per cluster, D, the output k in p of each body
        velocity or -1) of the functor's struct."""
        ens = self.ensemble
        slot = tuple(ens.out_idx.index(7 + r) if 7 + r in ens.out_idx else -1
                     for r in range(3))
        return ens.x_train.shape[1], ens.x_train.shape[2], len(ens.out_idx), slot

    def _layout(self) -> GPQuadDualParamsC:
        s = GPQuadDualParamsC()
        s.clusters, s.n, s.d_out, slot = self.cuda_layout()
        s.slot[:] = slot
        return s


class GPQuadSelectDynamics(_ClusterTableDynamics):
    """``f(x, u, p)``: the quad, plus the RDRv drag (``rdrv_d``) where
    given, plus the clustered body-frame GP residual of
    ``quad_residual_fn(ensemble, fixed_cluster)``
    (:func:`lane.quad_select_residual_terms`): each output's cluster pinned
    by ``fixed_cluster`` (:func:`pinned_clusters`), or, with none, the
    nearest centroid at every evaluation; ``p_dim = 0``. The dynamics of
    QuadMPC's ``residual_fn`` mode beyond one cluster, and of any
    ``quad_residual_fn`` with the drag.

    On the card the ``GPQuadSelectDyn`` functor of
    ``csrc/vde_gp_quad_select.cu`` computes the same function: the table of
    :class:`GPQuadDualDynamics` with the centroids appended, from a device
    buffer; the same layouts and capacity.
    """

    p_dim = 0
    cuda_functor = "GPQuadSelectDyn"
    cuda_source = "vde_gp_quad_select"
    cuda_entry = "vde_gp_quad_select"
    cuda_rk4_entry = "rk4_gp_quad_select"

    def __init__(self, ensemble: GPEnsemble,
                 params: QuadrotorParams = QuadrotorParams(), fixed_cluster=None,
                 rdrv_d=None):
        super().__init__(ensemble, params, rdrv_d)
        self.pin = pinned_clusters(ensemble, fixed_cluster)

    def with_ensemble(self, ensemble: GPEnsemble) -> "GPQuadSelectDynamics":
        return GPQuadSelectDynamics(ensemble, self.params, self.pin, self.D)

    def forward(self, x, u, p):
        return add_rows(self._nominal(x, u),
                        quad_select_residual_terms(self.ensemble, x, self.pin))

    def cuda_table(self) -> np.ndarray:
        return gp_quad_table(self.ensemble, self.cuda_functor, centroids=True)

    def cuda_layout(self) -> tuple:
        """(clusters, points per cluster, d, the body velocity of each
        feature (0 past d), each body velocity's pinned cluster or -1; 0 on
        a body velocity that is no output) of the functor's struct."""
        ens = self.ensemble
        feat = tuple(i - 7 for i in ens.feat_idx) + (0,) * (3 - len(ens.feat_idx))
        pin = [0, 0, 0]
        for k, dim in enumerate(ens.out_idx):
            pin[dim - 7] = -1 if self.pin is None else self.pin[k]
        return (ens.x_train.shape[1], ens.x_train.shape[2], len(ens.feat_idx),
                feat, tuple(pin))

    def _layout(self) -> GPQuadSelectParamsC:
        s = GPQuadSelectParamsC()
        s.clusters, s.n, s.d_feat, feat, pin = self.cuda_layout()
        s.feat[:], s.pin[:] = feat, pin
        return s
