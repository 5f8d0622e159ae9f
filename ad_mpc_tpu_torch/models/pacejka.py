"""Pacejka magic-formula bicycle with road topography (7-state, 2-input).

Port of ``ad_mpc_tpu/models/pacejka.py``. Lateral tire forces follow the
magic formula ``F_y = mu F_z D sin(C atan(B alpha))``; road pitch and roll
enter as gravity components in the body frame. Same 7-state layout as
:mod:`ad_mpc_tpu_torch.models.bicycle`, written entrywise with entries
leading, so one definition evaluates vectors, batches and slabs.

The JAX package evaluates ``atan`` by ``utils/math.py:atan_mosaic``, a
Mosaic workaround whose stated error is < 4e-7 in value and first
derivative; the port uses ``torch.atan`` (and the kernel ``atanf``).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
from torch import nn


class PacejkaParams(NamedTuple):
    """Plant and magic-formula coefficients (the JAX package's defaults:
    typical dry-asphalt passenger-car values)."""

    mass: float = 1500.0
    l_f: float = 1.08
    l_r: float = 1.62
    iz: float = 2625.0
    b_f: float = 10.0
    c_f: float = 1.9
    d_f: float = 1.0
    b_r: float = 12.0
    c_r: float = 1.9
    d_r: float = 1.0
    mu: float = 1.0  # road friction scaling
    g: float = 9.81
    road_pitch: float = 0.0  # [rad], positive = uphill
    road_roll: float = 0.0  # [rad], positive = right side down


def _cos(a):
    return torch.cos(a) if isinstance(a, torch.Tensor) else math.cos(a)


def _sin(a):
    return torch.sin(a) if isinstance(a, torch.Tensor) else math.sin(a)


def slip_angles(x, params: PacejkaParams):
    """Front and rear slip angles; v_x is floored at 0.5 m/s, so atan2 of
    the velocities is atan of their ratio."""
    v_x, v_y, psi_dot, delta = x[3], x[4], x[5], x[6]
    # torch.maximum splits the tangent at a tie, as jnp.maximum does.
    v_x_safe = torch.maximum(v_x, torch.full_like(v_x, 0.5))
    alpha_f = delta - torch.atan((v_y + params.l_f * psi_dot) / v_x_safe)
    alpha_r = -torch.atan((v_y - params.l_r * psi_dot) / v_x_safe)
    return alpha_f, alpha_r


def magic_formula(alpha, b, c, d, fz, mu):
    """Lateral force ``mu F_z D sin(C atan(B alpha))``."""
    return mu * fz * d * torch.sin(c * torch.atan(b * alpha))


def pacejka_bicycle_dynamics(x, u, params: PacejkaParams = PacejkaParams()):
    """Continuous-time dynamics x_dot = f(x, u) on entries-leading tensors;
    the same order of operations as the JAX package."""
    psi, v_x, v_y, psi_dot, delta = x[2], x[3], x[4], x[5], x[6]
    a_cmd, delta_dot = u[0], u[1]
    P = params

    wheelbase = P.l_f + P.l_r
    # Static axle normal loads, reduced by road pitch and roll.
    g_eff = P.g * _cos(P.road_pitch) * _cos(P.road_roll)
    fz_f = P.mass * g_eff * P.l_r / wheelbase
    fz_r = P.mass * g_eff * P.l_f / wheelbase

    alpha_f, alpha_r = slip_angles(x, P)
    f_fy = magic_formula(alpha_f, P.b_f, P.c_f, P.d_f, fz_f, P.mu)
    f_ry = magic_formula(alpha_r, P.b_r, P.c_r, P.d_r, fz_r, P.mu)

    # Gravity feed-through from the road topography (body frame).
    a_grav_x = -P.g * _sin(P.road_pitch)
    a_grav_y = P.g * _sin(P.road_roll)

    p_x_dot = v_x * torch.cos(psi) - v_y * torch.sin(psi)
    p_y_dot = v_x * torch.sin(psi) + v_y * torch.cos(psi)
    v_x_dot = a_cmd + a_grav_x - f_fy * torch.sin(delta) / P.mass + v_y * psi_dot
    v_y_dot = (f_ry + f_fy * torch.cos(delta)) / P.mass + a_grav_y - v_x * psi_dot
    psi_ddot = (P.l_f * f_fy * torch.cos(delta) - P.l_r * f_ry) / P.iz

    return torch.stack([p_x_dot, p_y_dot, psi_dot, v_x_dot, v_y_dot, psi_ddot,
                        delta_dot])


def pacejka_dynamics_p(x, u, p, params: PacejkaParams = PacejkaParams()):
    """Pacejka dynamics with per-scenario parameters.

    ``p = [mu, road_pitch, road_roll]`` (3 entries) or
    ``p = [mu, pitch, roll, b_scale, d_scale]`` (5 entries), the last two
    scaling the magic-formula stiffness B and peak D front and rear."""
    params = params._replace(mu=p[0], road_pitch=p[1], road_roll=p[2])
    if p.shape[0] >= 5:
        params = params._replace(
            b_f=params.b_f * p[3], b_r=params.b_r * p[3],
            d_f=params.d_f * p[4], d_r=params.d_r * p[4],
        )
    return pacejka_bicycle_dynamics(x, u, params)


class PacejkaParamsC(ctypes.Structure):
    """``PacejkaParamsC`` of ``csrc/vde_bicycle.cu``, passed to the kernel by value:
    the constant scalars, each rounded once to float32 (the wheelbase
    summed in double, as the Python model sums it)."""

    _fields_ = [(n, ctypes.c_float) for n in (
        "mass", "l_f", "l_r", "iz", "b_f", "c_f", "d_f", "b_r", "c_r", "d_r",
        "g", "wheelbase")]


class PacejkaDynamics(nn.Module):
    """``f(x, u, p) = pacejka_dynamics_p(x, u, p, params)`` with the
    5-entry p of the c4 sweep (mu, pitch, roll, B scale, D scale).

    ``nx``, ``nu`` and ``p_dim`` state the functor's shape; ``cuda_entry``
    and ``cuda_rk4_entry`` name the C entries of ``csrc/vde_bicycle.cu`` that run
    the VDE kernel and its RK4 kernel with the ``PacejkaDyn`` functor
    (``cuda_functor``), and ``cuda_params`` builds the struct both take.
    ``cuda_team``: the sweep takes the team entry's launch geometry
    (``ops/cuda_vde.py:vde_geometry``), a team of 1, a thread per row, as
    committed (its teams lost, ``PERF.md``).
    """

    nx, nu, p_dim = 7, 2, 5
    cuda_team = True
    cuda_functor = "PacejkaDyn"
    cuda_source = "vde_bicycle"
    cuda_entry = "vde_pacejka"
    cuda_rk4_entry = "rk4_pacejka"

    def __init__(self, params: PacejkaParams = PacejkaParams()):
        super().__init__()
        self.params = params

    def forward(self, x, u, p):
        return pacejka_dynamics_p(x, u, p, self.params)

    def cuda_params(self) -> PacejkaParamsC:
        P = self.params
        return PacejkaParamsC(P.mass, P.l_f, P.l_r, P.iz, P.b_f, P.c_f, P.d_f,
                              P.b_r, P.c_r, P.d_r, P.g, P.l_f + P.l_r)
