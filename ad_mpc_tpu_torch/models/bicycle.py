"""Velocity-blended kinematic/dynamic bicycle model (7-state, 2-input).

Port of ``ad_mpc_tpu/models/bicycle.py:22-114``. The dynamics is written
entrywise with entries leading (``x[3]``, ``torch.stack``), so one
definition evaluates ``(nx,)`` vectors, ``(nx, B)`` batches and
``(nx, N, B)`` slabs alike — the lane contract of the fused VDE kernel.
It also evaluates sequences of Python floats (``math`` in place of
``torch``, a list out): the host plant's scalar path
(``sim/simulator.py``), where a tensor operation's overhead would cost
more than the arithmetic.

State  x = [p_x, p_y, psi, v_x, v_y, psi_dot, delta]
Input  u = [a, delta_dot]   (longitudinal acceleration, steering rate)
Param  switch in [0, 1]     (0 = kinematic model, 1 = dynamic linear-tire)
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
from torch import nn


class BicycleParams(NamedTuple):
    """Physical + constraint parameters of the bicycle plant (the JAX
    package's defaults: 1500 kg sedan, 2.7 m wheelbase)."""

    mass: float = 1500.0
    l_f: float = 2.7 * (1.0 - 900.0 / 1500.0)  # CoG -> front axle [m]
    l_r: float = 2.7 * (1.0 - 600.0 / 1500.0)  # CoG -> rear axle [m]
    iz: float = (2.7 * 0.4) * (2.7 * 0.6) * 1500.0  # yaw inertia [kg m^2]
    cf: float = 900.0 * 0.5 * 9.81 * 0.165 * 180.0 / 3.14195  # [N/rad]
    cr: float = 600.0 * 0.5 * 9.81 * 0.165 * 180.0 / 3.14195  # [N/rad]
    # Kinematic->dynamic blending speeds [m/s].
    blend_min: float = 100.0
    blend_max: float = 110.0
    # Input / state bounds.
    steering_min: float = -0.52
    steering_max: float = 0.52
    steering_rate_min: float = -3.0
    steering_rate_max: float = 3.0
    acc_min: float = -10.0
    acc_max: float = 5.0


NX = 7
NU = 2


def blend_switch(v_x, params: BicycleParams):
    """Velocity-based blend factor in [0,1]: 0 below blend_min (kinematic),
    1 above blend_max (dynamic)."""
    s = (v_x - params.blend_min) / (params.blend_max - params.blend_min)
    if isinstance(s, torch.Tensor):
        return torch.clamp(s, 0.0, 1.0)
    return min(max(s, 0.0), 1.0)


def lateral_tire_forces(x, params: BicycleParams):
    """Linear-tire lateral forces (front, rear); ``v_x + 1e-6`` guards the
    slip-angle division."""
    v_x, v_y, psi_dot, delta = x[3], x[4], x[5], x[6]
    v_x_safe = v_x + 1e-6
    f_fy = 2.0 * params.cf * (delta - (v_y + params.l_f * psi_dot) / v_x_safe)
    f_ry = 2.0 * params.cr * (params.l_r * psi_dot - v_y) / v_x_safe
    return f_fy, f_ry


def bicycle_dynamics(x, u, params: BicycleParams = BicycleParams(), switch=None):
    """Continuous-time dynamics x_dot = f(x, u) on entries-leading tensors.

    ``switch`` overrides the blend parameter; by default it is computed
    from the state's own v_x.
    """
    psi, v_x, v_y, psi_dot, delta = x[2], x[3], x[4], x[5], x[6]
    a, delta_dot = u[0], u[1]
    s = blend_switch(v_x, params) if switch is None else switch

    f_fy, f_ry = lateral_tire_forces(x, params)
    on_tensors = isinstance(psi, torch.Tensor)
    cos, sin = (torch.cos, torch.sin) if on_tensors else (math.cos, math.sin)

    p_x_dot = v_x * cos(psi) - v_y * sin(psi)
    p_y_dot = v_x * sin(psi) + v_y * cos(psi)

    v_x_dyn = a - (f_fy * sin(delta)) / params.mass + v_y * psi_dot
    v_x_kin = a

    wheelbase = params.l_f + params.l_r
    v_y_dyn = (f_ry + f_fy * cos(delta)) / params.mass - v_x * psi_dot
    v_y_kin = (delta_dot * v_x + delta * a) * params.l_r / wheelbase

    psi_dd_dyn = (
        params.l_f * f_fy * cos(delta) - params.l_r * f_ry
    ) / params.iz
    psi_dd_kin = (delta_dot * v_x + delta * a) / wheelbase

    rows = [
        p_x_dot,
        p_y_dot,
        psi_dot,
        s * v_x_dyn + (1 - s) * v_x_kin,
        s * v_y_dyn + (1 - s) * v_y_kin,
        s * psi_dd_dyn + (1 - s) * psi_dd_kin,
        delta_dot,
    ]
    return torch.stack(rows) if on_tensors else rows


class BicycleParamsC(ctypes.Structure):
    """``BicycleParamsC`` of ``csrc/vde.cu``, passed to the kernel by value."""

    _fields_ = [(n, ctypes.c_float)
                for n in ("mass", "l_f", "l_r", "iz", "cf", "cr", "wheelbase")]


class BicycleDynamics(nn.Module):
    """``f(x, u, p) = bicycle_dynamics(x, u, params, switch=p[0])``: the
    blend switch is the per-scenario stage parameter.

    ``nx``, ``nu`` and ``p_dim`` state the functor's shape;
    ``cuda_entry`` and ``cuda_rk4_entry`` name the C entries of
    ``csrc/vde.cu`` that run the VDE kernel and its tangent-free RK4 kernel
    with this model's ``__device__`` functor, and ``cuda_params`` builds
    the parameter struct both take by value.
    """

    nx, nu, p_dim = NX, NU, 1
    cuda_functor = "BicycleDyn"
    cuda_entry = "vde_bicycle"
    cuda_rk4_entry = "rk4_bicycle"

    def __init__(self, params: BicycleParams = BicycleParams()):
        super().__init__()
        self.params = params

    def forward(self, x, u, p):
        return bicycle_dynamics(x, u, self.params, switch=p[0])

    def cuda_params(self) -> BicycleParamsC:
        """The scalars of the functor; the wheelbase is summed in double
        precision as the Python model sums it."""
        P = self.params
        return BicycleParamsC(P.mass, P.l_f, P.l_r, P.iz, P.cf, P.cr,
                              P.l_f + P.l_r)
