"""13-state quadrotor dynamics (position, quaternion, world velocity, body
rates) with 4 normalized motor inputs.

Port of ``ad_mpc_tpu/models/quadrotor.py:28-184``. :func:`quad_dynamics` is
the matmul form on one state vector (with the optional RDRv drag matrix);
:func:`quad_dynamics_lane` is the entrywise form with entries leading
(``x[3]``, ``torch.stack``), so it evaluates ``(13,)`` vectors and
``(13, N, B)`` slabs alike. The lane form is the plain version of the
``QuadDyn`` functor in ``csrc/vde_quad.cu``, which keeps its order of
operations; :class:`QuadDragDynamics` adds the RDRv drag entrywise
(:func:`quad_drag_rows`), the plain version of ``QuadDragDyn``.

State  x = [p(3), q_wxyz(4), v_world(3), w_body(3)]
Input  u in [0,1]^4  (normalized motor thrusts)
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ad_mpc_tpu_torch.learned.lane import _rot_rows, add_rows
from ad_mpc_tpu_torch.utils.math import (
    quaternion_inverse,
    skew_symmetric,
    v_dot_q,
)


def _rotor_xy(length: float, configuration: str):
    """Thruster positions for 'x' or '+' airframes."""
    if configuration == "+":
        x_f = np.array([length, 0.0, -length, 0.0])
        y_f = np.array([0.0, length, 0.0, -length])
    else:  # 'x'
        h = np.cos(np.pi / 4) * length
        x_f = np.array([h, -h, -h, h])
        y_f = np.array([-h, -h, h, h])
    return x_f, y_f


class QuadrotorParams(NamedTuple):
    """Physical parameters; the defaults are the JAX package's (the
    reference quad)."""

    mass: float = 1.0  # [kg]
    j: tuple = (0.03, 0.03, 0.06)  # diagonal inertia [kg m^2]
    max_thrust: float = 20.0  # per-motor max thrust [N]
    length: float = 0.47 / 2  # arm length [m]
    c_torque: float = 0.013  # z-torque per unit thrust [m]
    configuration: str = "x"
    g: float = 9.81

    @property
    def x_f(self):
        return _rotor_xy(self.length, self.configuration)[0]

    @property
    def y_f(self):
        return _rotor_xy(self.length, self.configuration)[1]

    @property
    def z_l_tau(self):
        c = self.c_torque
        return np.array([-c, c, -c, c])


NX = 13
NU = 4


def quad_dynamics(x, u, params: QuadrotorParams = QuadrotorParams(), rdrv_d=None):
    """Continuous-time dynamics x_dot = f(x, u) of one state x (13,) and
    input u (4,), in matrix form.

    :param rdrv_d: optional (3,3) linear drag matrix D; adds
        ``R(q) @ D @ R(q)^T v`` to the velocity dynamics (RDRv model).
    """
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=x.dtype, device=x.device)
    q, v, w = x[3:7], x[7:10], x[10:13]
    f_thrust = u * params.max_thrust
    j = as_t(params.j)

    p_dot = v
    q_dot = 0.5 * skew_symmetric(w) @ q
    a_thrust = as_t([0.0, 0.0, 1.0]) * torch.sum(f_thrust) / params.mass
    v_dot = v_dot_q(a_thrust, q) - as_t([0.0, 0.0, params.g])
    if rdrv_d is not None:
        v_b = v_dot_q(v, quaternion_inverse(q))
        v_dot = v_dot + v_dot_q(as_t(rdrv_d) @ v_b, q)

    x_f, y_f, z_l = as_t(params.x_f), as_t(params.y_f), as_t(params.z_l_tau)
    w_dot = torch.stack([
        (torch.dot(f_thrust, y_f) + (j[1] - j[2]) * w[1] * w[2]) / j[0],
        (-torch.dot(f_thrust, x_f) + (j[2] - j[0]) * w[2] * w[0]) / j[1],
        (torch.dot(f_thrust, z_l) + (j[0] - j[1]) * w[0] * w[1]) / j[2],
    ])
    return torch.cat([p_dot, q_dot, v_dot, w_dot])


def quad_dynamics_lane(x, u, p=None, params: QuadrotorParams = QuadrotorParams()):
    """The entrywise form of :func:`quad_dynamics` with ``rdrv_d=None``:
    the quaternion kinematics, the thrust rotation and the inertia torques
    expanded entry by entry, with Python-float coefficients. ``p`` is
    accepted for the ``f(x, u, p)`` contract and ignored."""
    del p
    qw, qx, qy, qz = x[3], x[4], x[5], x[6]
    vx, vy, vz = x[7], x[8], x[9]
    wx, wy, wz = x[10], x[11], x[12]

    t0 = u[0] * params.max_thrust
    t1 = u[1] * params.max_thrust
    t2 = u[2] * params.max_thrust
    t3 = u[3] * params.max_thrust

    # Quaternion kinematics q_dot = 1/2 Omega(w) q, expanded.
    q_dot_w = 0.5 * (-qx * wx - qy * wy - qz * wz)
    q_dot_x = 0.5 * (qw * wx + qy * wz - qz * wy)
    q_dot_y = 0.5 * (qw * wy - qx * wz + qz * wx)
    q_dot_z = 0.5 * (qw * wz + qx * wy - qy * wx)

    # v_dot = R(q) [0, 0, T/m] - g z_hat: third column of R(q), expanded.
    a = (t0 + t1 + t2 + t3) / params.mass
    v_dot_x = 2.0 * (qx * qz + qw * qy) * a
    v_dot_y = 2.0 * (qy * qz - qw * qx) * a
    v_dot_z = (1.0 - 2.0 * qx * qx - 2.0 * qy * qy) * a - params.g

    # Body-rate dynamics: thrust moments + Euler inertia coupling.
    jxx, jyy, jzz = (float(v) for v in params.j)
    x_f = [float(v) for v in params.x_f]
    y_f = [float(v) for v in params.y_f]
    z_l = [float(v) for v in params.z_l_tau]
    m_x = t0 * y_f[0] + t1 * y_f[1] + t2 * y_f[2] + t3 * y_f[3]
    m_y = -(t0 * x_f[0] + t1 * x_f[1] + t2 * x_f[2] + t3 * x_f[3])
    m_z = t0 * z_l[0] + t1 * z_l[1] + t2 * z_l[2] + t3 * z_l[3]
    w_dot_x = (m_x + (jyy - jzz) * wy * wz) / jxx
    w_dot_y = (m_y + (jzz - jxx) * wz * wx) / jyy
    w_dot_z = (m_z + (jxx - jyy) * wx * wy) / jzz

    return torch.stack([
        vx, vy, vz,
        q_dot_w, q_dot_x, q_dot_y, q_dot_z,
        v_dot_x, v_dot_y, v_dot_z,
        w_dot_x, w_dot_y, w_dot_z,
    ])


def quad_drag_rows(x, D) -> dict:
    """The RDRv drag ``R(q) D R(q)^T v`` of :func:`quad_dynamics` entrywise,
    by velocity row: ``{7 + r: t_r}``, in the order of ``csrc/vde_quad.cu:
    quad_drag_terms`` and ``csrc/vde_models.cuh:gp_quad_rows`` (v_b = R^T v,
    w = D v_b, t = R w). ``D`` is a 3x3 array of Python floats."""
    R = _rot_rows(x)
    v_b = [R[0][k] * x[7] + R[1][k] * x[8] + R[2][k] * x[9] for k in range(3)]
    w = [D[r][0] * v_b[0] + D[r][1] * v_b[1] + D[r][2] * v_b[2] for r in range(3)]
    return {7 + r: R[r][0] * w[0] + R[r][1] * w[1] + R[r][2] * w[2]
            for r in range(3)}


def drag_matrix(rdrv_d) -> list:
    """The RDRv drag matrix as a 3x3 list of Python floats (the constants
    :func:`quad_drag_rows` folds in); refuses another shape."""
    D = np.asarray(rdrv_d, np.float64)
    if D.shape != (3, 3):
        raise ValueError(f"rdrv_d must be 3x3, got {D.shape}")
    return [[float(v) for v in row] for row in D]


def normalize_quat_state(x):
    """Renormalize the quaternion block of 13D states x (..., 13)."""
    q = x[..., 3:7]
    return torch.cat([x[..., :3], q / torch.linalg.norm(q, dim=-1, keepdim=True),
                      x[..., 7:]], dim=-1)


def input_bounds(params: QuadrotorParams = QuadrotorParams()):
    """Normalized motor thrust bounds [0, 1]."""
    return np.zeros(NU), np.ones(NU)


def hover_input(params: QuadrotorParams = QuadrotorParams()):
    """Normalized input where total thrust balances gravity."""
    return np.full(NU, params.mass * params.g / (NU * params.max_thrust))


class QuadParamsC(ctypes.Structure):
    """``QuadParamsC`` of ``csrc/vde_models.cuh``, passed to the kernel by value: the
    scalars :func:`quad_dynamics_lane` folds in, each rounded once to
    float32 from the double the Python model computes."""

    _fields_ = ([(n, ctypes.c_float) for n in (
        "max_thrust", "mass", "g", "jxx", "jyy", "jzz", "jyy_jzz", "jzz_jxx",
        "jxx_jyy")] + [(n, ctypes.c_float * 4) for n in ("x_f", "y_f", "z_l")])


class QuadDynamics(nn.Module):
    """``f(x, u, p) = quad_dynamics_lane(x, u, params)``; ``p`` is ignored
    (the quad fleet has ``p_dim=0``).

    ``nx``, ``nu`` and ``p_dim`` state the functor's shape;
    ``cuda_entry`` and ``cuda_rk4_entry`` name the C entries of
    ``csrc/vde_quad.cu`` that run the VDE kernel and its tangent-free RK4 kernel
    with the ``QuadDyn`` functor, and ``cuda_params`` builds the parameter
    struct both take by value. ``cuda_team``: the sweep runs a team of lanes
    per row (``ops/cuda_vde.py:vde_geometry``).
    """

    nx, nu, p_dim = NX, NU, 0
    cuda_team = True
    cuda_functor = "QuadDyn"
    cuda_source = "vde_quad"
    cuda_entry = "vde_quad"
    cuda_rk4_entry = "rk4_quad"

    def __init__(self, params: QuadrotorParams = QuadrotorParams()):
        super().__init__()
        self.params = params

    def forward(self, x, u, p):
        return quad_dynamics_lane(x, u, None, self.params)

    def cuda_params(self) -> QuadParamsC:
        P = self.params
        jxx, jyy, jzz = (float(v) for v in P.j)
        arr = lambda a: (ctypes.c_float * 4)(*(float(v) for v in a))
        return QuadParamsC(P.max_thrust, P.mass, P.g, jxx, jyy, jzz, jyy - jzz,
                           jzz - jxx, jxx - jyy, arr(P.x_f), arr(P.y_f),
                           arr(P.z_l_tau))


class QuadDragParamsC(ctypes.Structure):
    """``QuadDragParamsC`` of ``csrc/vde_quad.cu``, passed to the kernel by
    value: the quad's scalars and the drag matrix D, row-major, each rounded
    once to float32."""

    _fields_ = [("quad", QuadParamsC), ("D", (ctypes.c_float * 3) * 3)]


class QuadDragDynamics(nn.Module):
    """``f(x, u, p) = quad_dynamics(x, u, params, rdrv_d=D)``, entrywise:
    :func:`quad_dynamics_lane` plus :func:`quad_drag_rows`; ``p`` is ignored
    (``p_dim=0``). The counterpart of QuadMPC's ``rdrv_d`` mode.

    ``cuda_entry`` and ``cuda_rk4_entry`` name the C entries of
    ``csrc/vde_quad.cu`` that run the VDE kernel and its RK4 kernel with the
    ``QuadDragDyn`` functor (``cuda_functor``); ``cuda_params`` builds the
    struct both take by value. ``cuda_team``: the sweep runs a team of lanes
    per row, as :class:`QuadDynamics`'s.
    """

    nx, nu, p_dim = NX, NU, 0
    cuda_team = True
    cuda_functor = "QuadDragDyn"
    cuda_source = "vde_quad"
    cuda_entry = "vde_quad_drag"
    cuda_rk4_entry = "rk4_quad_drag"

    def __init__(self, rdrv_d, params: QuadrotorParams = QuadrotorParams()):
        super().__init__()
        self.D = drag_matrix(rdrv_d)
        self.params = params

    def forward(self, x, u, p):
        return add_rows(quad_dynamics_lane(x, u, None, self.params),
                        quad_drag_rows(x, self.D))

    def cuda_params(self) -> QuadDragParamsC:
        s = QuadDragParamsC()
        s.quad = QuadDynamics(self.params).cuda_params()
        for r in range(3):
            s.D[r][:] = self.D[r]
        return s
