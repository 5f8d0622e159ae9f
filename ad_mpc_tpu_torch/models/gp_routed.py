"""The parameter-routed GP dynamics: each scenario's cluster in its p row.

The counterpart of the dynamics that ``ad_mpc_tpu/learned/lane.py:200-253``
(``param_residual_dynamics``) composes: a base model plus a GP residual
whose training set, weights and scales are read from the scenario's
parameter row behind the base's own entries, one selected cluster per
output dim (``learned.lane.ClusterPacker`` builds the rows). One launch
then serves a fleet whose scenarios use different clusters.

Two forms have a functor on the card:

- :class:`GPRoutedDynamics` (``GPRoutedDyn`` of ``csrc/vde_gp_bicycle.cu``):
  the plain form on the bicycle, features ``x[3..6]``, outputs rows 4
  and 5, the base's switch in ``p[0]``: the JAX package's own test
  construction (``tests/test_pallas_vde.py:254-300``);
- :class:`GPQuadRoutedDynamics` (``GPQuadRoutedDyn`` of
  ``csrc/vde_gp_quad_routed.cu``): ``quad_frame=True`` on the quadrotor, features
  the body-frame velocities, means rotated back onto rows 7-9.

Each takes at most :data:`GP_ROUTED_POINTS` or :data:`GP_QUAD_ROUTED_POINTS`
training points per output dim and refuses more by name. The kernels copy
the p rows of a block's scenarios to shared memory before any row
(``cuda_rows``; the quad form's sweep runs a team of lanes per row,
``cuda_team``, and stages them after the block's tile). Any other base or
layout is :class:`RoutedGPDynamics`, on the plain backend only.
"""

from __future__ import annotations

import ctypes

from torch import nn

from ad_mpc_tpu_torch.learned.ensemble import GPEnsemble
from ad_mpc_tpu_torch.learned.lane import _rot_rows, add_rows, param_gp_mean
from ad_mpc_tpu_torch.models.bicycle import BicycleDynamics, BicycleParamsC
from ad_mpc_tpu_torch.models.quadrotor import QuadDynamics, QuadParamsC

# Capacities of the functors (GP_ROUTED_POINTS, GP_QUAD_ROUTED_POINTS of
# csrc/vde_gp_bicycle.cu and csrc/vde_gp_quad_routed.cu) and the layouts they serve.
GP_ROUTED_POINTS, GP_QUAD_ROUTED_POINTS = 32, 64
BICYCLE_LAYOUT = ((4, 5), (3, 4, 5, 6))  # (out_idx, feat_idx)
QUAD_LAYOUT = ((7, 8, 9), (7, 8, 9))


class RoutedGPDynamics(nn.Module):
    """``f(x, u, p) = base(x, u, p)`` plus the routed GP residual of
    ``ensemble``'s shape, read from ``p[base_p_dim:]``: per output dim
    ``k`` the mean at the features (``x[feat_idx]``, or with
    ``quad_frame`` the body-frame velocities ``R(q)^T v``) added to row
    ``out_idx[k]`` (with ``quad_frame``, rotated back: rows 7-9 get
    ``R(q) mu``). ``p_dim = base_p_dim + gp_param_dim``. No functor: the
    plain backend only."""

    cuda_entry = None
    table_in_p = True  # the GP's table is in p (testing.table_perturbed)
    cuda_rows = True  # a functor's kernels stage the block's p rows (P_ROWS)

    def __init__(self, ensemble: GPEnsemble, base, base_p_dim: int,
                 quad_frame: bool = False):
        super().__init__()
        D, _, n, d = ensemble.x_train.shape
        if quad_frame and (tuple(ensemble.out_idx), tuple(ensemble.feat_idx)) != QUAD_LAYOUT:
            raise ValueError("the quad-frame routed GP serves out_idx = feat_idx = "
                             f"{QUAD_LAYOUT[0]}; got {ensemble.out_idx}, {ensemble.feat_idx}")
        self.ensemble, self.base = ensemble, base
        self.base_p_dim, self.quad_frame = int(base_p_dim), quad_frame
        self.n, self.d, self.per = n, d, n * d + n + d + 2
        self.nx, self.nu = base.nx, base.nu
        self.p_dim = self.base_p_dim + D * self.per

    def _mean(self, p, k, z):
        return param_gp_mean(self.n, self.d, p, self.base_p_dim + k * self.per, z)

    def forward(self, x, u, p):
        ens = self.ensemble
        if not self.quad_frame:
            z = [x[i] for i in ens.feat_idx]
            return add_rows(self.base(x, u, p), {
                dim: self._mean(p, k, z) for k, dim in enumerate(ens.out_idx)})
        R = _rot_rows(x)
        v_b = [R[0][r] * x[7] + R[1][r] * x[8] + R[2][r] * x[9] for r in range(3)]
        mu = [self._mean(p, k, v_b) for k in range(3)]
        return add_rows(self.base(x, u, p), {
            7 + r: R[r][0] * mu[0] + R[r][1] * mu[1] + R[r][2] * mu[2] for r in range(3)})


class GPRoutedParamsC(ctypes.Structure):
    """``GPRoutedParamsC`` of ``csrc/vde_gp_bicycle.cu``, by value: the
    bicycle's scalars, the points per output dim and the base's entries."""

    _fields_ = [("bike", BicycleParamsC), ("n", ctypes.c_int), ("base_pd", ctypes.c_int)]


class GPRoutedDynamics(RoutedGPDynamics):
    """The bicycle plus the routed GP of the bicycle layout (``out_idx =
    (4, 5)``, ``feat_idx = (3, 4, 5, 6)``): the ``GPRoutedDyn`` functor."""

    cuda_functor = "GPRoutedDyn"
    cuda_source = "vde_gp_bicycle"
    cuda_entry = "vde_gp_routed"
    cuda_rk4_entry = "rk4_gp_routed"

    def cuda_params(self) -> GPRoutedParamsC:
        """The functor's struct; refuses a layout or a size it cannot take."""
        ens = self.ensemble
        if (tuple(ens.out_idx), tuple(ens.feat_idx)) != BICYCLE_LAYOUT:
            raise ValueError(f"the GPRoutedDyn functor serves out_idx, feat_idx = "
                             f"{BICYCLE_LAYOUT}; got {ens.out_idx}, {ens.feat_idx}")
        if self.n > GP_ROUTED_POINTS or self.base_p_dim < 1:
            raise ValueError(f"the GPRoutedDyn functor holds {GP_ROUTED_POINTS} points "
                             f"per output behind the bicycle's switch; got {self.n} "
                             f"points, base_p_dim {self.base_p_dim}")
        return GPRoutedParamsC(self.base.cuda_params(), self.n, self.base_p_dim)


class GPQuadRoutedParamsC(ctypes.Structure):
    """``GPQuadRoutedParamsC`` of ``csrc/vde_gp_quad_routed.cu``, by value: the
    quad's scalars, the points per output dim and the base's entries."""

    _fields_ = [("quad", QuadParamsC), ("n", ctypes.c_int), ("base_pd", ctypes.c_int)]


class GPQuadRoutedDynamics(RoutedGPDynamics):
    """The quadrotor plus the routed body-frame GP: the ``GPQuadRoutedDyn``
    functor, a team of lanes per row (``cuda_team``)."""

    cuda_team = True
    cuda_functor = "GPQuadRoutedDyn"
    cuda_source = "vde_gp_quad_routed"
    cuda_entry = "vde_gp_quad_routed"
    cuda_rk4_entry = "rk4_gp_quad_routed"

    def cuda_params(self) -> GPQuadRoutedParamsC:
        """The functor's struct; refuses more points than its capacity."""
        if self.n > GP_QUAD_ROUTED_POINTS:
            raise ValueError(f"the GPQuadRoutedDyn functor holds {GP_QUAD_ROUTED_POINTS} "
                             f"points per output; got {self.n} (p_dim {self.p_dim})")
        return GPQuadRoutedParamsC(self.base.cuda_params(), self.n, self.base_p_dim)


def routed_dynamics(ens: GPEnsemble, base, base_p_dim: int, quad_frame: bool = False):
    """The routed dynamics of ``base`` and ``ens``: the form with a functor
    where the base and layout have one, else :class:`RoutedGPDynamics`."""
    if quad_frame and type(base) is QuadDynamics:
        return GPQuadRoutedDynamics(ens, base, base_p_dim, True)
    if (not quad_frame and type(base) is BicycleDynamics
            and (tuple(ens.out_idx), tuple(ens.feat_idx)) == BICYCLE_LAYOUT):
        return GPRoutedDynamics(ens, base, base_p_dim)
    return RoutedGPDynamics(ens, base, base_p_dim, quad_frame)
