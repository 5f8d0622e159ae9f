"""Math helpers (port of ``ad_mpc_tpu/utils/math.py:56-281``).

Quaternions are ``[w, x, y, z]`` (Hamilton convention), as in the JAX
package. The quaternion helpers broadcast over leading batch axes.
``atan_mosaic`` and ``atan2_mosaic`` (TPU lowering workarounds) are not
ported: ``torch.atan``/``torch.atan2`` serve.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def skew_symmetric(v):
    """4x4 quaternion-kinematics matrix Omega(v) with q_dot = 1/2 Omega(w) q:
    v (..., 3) -> (..., 4, 4)."""
    z = torch.zeros_like(v[..., 0])
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    rows = [
        torch.stack([z, -vx, -vy, -vz], dim=-1),
        torch.stack([vx, z, vz, -vy], dim=-1),
        torch.stack([vy, -vz, z, vx], dim=-1),
        torch.stack([vz, vy, -vx, z], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def q_to_rot_mat(q):
    """Unit quaternion (..., 4) [w,x,y,z] -> rotation matrix (..., 3, 3)."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (qy**2 + qz**2)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx**2 + qz**2)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx**2 + qy**2)
    rows = [
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def v_dot_q(v, q):
    """Rotate vector v (..., 3) by unit quaternion q (..., 4)."""
    return torch.einsum("...ij,...j->...i", q_to_rot_mat(q), v)


def quaternion_inverse(q):
    """Conjugate of a unit quaternion (..., 4)."""
    return torch.stack([q[..., 0], -q[..., 1], -q[..., 2], -q[..., 3]], dim=-1)


def yaw_wrap_reference(psi_ref, psi0):
    """ACADOS-parity yaw-wrap correction of a yaw reference against the
    current state's yaw:

    - if psi0 < 0 and psi0 + pi < ref: ref -= 2*pi
    - if psi0 > 0 and psi0 - pi > ref: ref += 2*pi

    ``psi0`` broadcasts against ``psi_ref`` (pass ``x0[:, i, None]`` for a
    (B, N+1) batch of references).
    """
    down = (psi0 < 0) & (psi0 + math.pi < psi_ref)
    up = (psi0 > 0) & (psi0 - math.pi > psi_ref)
    dt = psi_ref.dtype
    return psi_ref - 2 * math.pi * down.to(dt) + 2 * math.pi * up.to(dt)


def wrap_to_pi(angle):
    """Wrap angle(s) to [-pi, pi) (reference ``bound_angle_within_pi``):
    ``(angle + pi) mod 2 pi - pi`` with the modulo as ``jnp.remainder``
    computes it, the truncated remainder moved into the divisor's sign."""
    a = torch.as_tensor(angle) + math.pi
    two_pi = 2.0 * math.pi
    r = torch.fmod(a, two_pi)
    r = torch.where((r != 0) & (r < 0), r + two_pi, r)
    return r - math.pi


def unwrap_angles(angles, dim=-1):
    """``np.unwrap``: remove jumps larger than pi along ``dim``."""
    d = torch.diff(angles, dim=dim)
    correction = torch.cumsum(wrap_to_pi(d) - d, dim=dim)
    zero = torch.zeros_like(angles.narrow(dim, 0, 1))
    return angles + torch.cat([zero, correction], dim=dim)


def fix_angle_reference(angle_ref, angle_init):
    """Shift a reference angle sequence by multiples of 2 pi so that it
    starts within pi of ``angle_init`` and has no 2 pi jumps."""
    return angle_init + unwrap_angles(wrap_to_pi(angle_ref - angle_init))


def skew_3d(v):
    """3x3 cross-product matrix, ``skew_3d(v) @ u == cross(v, u)``:
    v (..., 3) -> (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    rows = [
        torch.stack([z, -vz, vy], dim=-1),
        torch.stack([vz, z, -vx], dim=-1),
        torch.stack([-vy, vx, z], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def unit_quat(q):
    """Normalize quaternions (..., 4) to unit modulus."""
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def q_dot_q(q, r):
    """Hamilton product q*r of quaternions (..., 4) [w,x,y,z]."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rw, rx, ry, rz = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return torch.stack([
        qw * rw - qx * rx - qy * ry - qz * rz,
        qw * rx + qx * rw + qy * rz - qz * ry,
        qw * ry - qx * rz + qy * rw + qz * rx,
        qw * rz + qx * ry - qy * rx + qz * rw,
    ], dim=-1)


def quaternion_to_euler(q):
    """Unit quaternion (..., 4) -> (roll, pitch, yaw) (..., 3), ZYX."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2 * (qw * qx + qy * qz), 1 - 2 * (qx**2 + qy**2))
    pitch = torch.asin(torch.clamp(2 * (qw * qy - qz * qx), -1.0, 1.0))
    yaw = torch.atan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy**2 + qz**2))
    return torch.stack([roll, pitch, yaw], dim=-1)


def euler_to_quaternion(roll, pitch, yaw):
    """ZYX Euler angles (tensors of one shape) -> unit quaternion (..., 4)."""
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    return torch.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ], dim=-1)


def rotation_matrix_to_quat(rot):
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), branch-free
    Shepperd: the four candidate extractions, the best-conditioned one
    picked per matrix."""
    m = lambda i, j: rot[..., i, j]
    m00, m01, m02 = m(0, 0), m(0, 1), m(0, 2)
    m10, m11, m12 = m(1, 0), m(1, 1), m(1, 2)
    m20, m21, m22 = m(2, 0), m(2, 1), m(2, 2)
    tr = m00 + m11 + m22
    qw2 = torch.clamp(1 + tr, min=0.0)
    qx2 = torch.clamp(1 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1 - m00 - m11 + m22, min=0.0)
    eps = 1e-12
    cand = lambda comps, s: torch.stack(comps, dim=-1) / (
        2 * torch.sqrt(s + eps)[..., None])
    cands = torch.stack([
        cand([qw2, m21 - m12, m02 - m20, m10 - m01], qw2),
        cand([m21 - m12, qx2, m01 + m10, m02 + m20], qx2),
        cand([m02 - m20, m01 + m10, qy2, m12 + m21], qy2),
        cand([m10 - m01, m02 + m20, m12 + m21, qz2], qz2),
    ], dim=-2)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    return unit_quat(torch.gather(cands, -2, idx)[..., 0, :])


def undo_quaternion_flip(q_past, q_current):
    """Keep quaternion sign continuity: -q_current where q_past is closer to
    it than to q_current."""
    flip = (torch.sum((q_past - q_current) ** 2, dim=-1)
            > torch.sum((q_past + q_current) ** 2, dim=-1))
    return torch.where(flip[..., None], -q_current, q_current)


def interpol_mse(t_1, x_1, t_2, x_2):
    """RMSE between the positions x_1 (n, k) at the times t_1 and x_2 (m, k)
    interpolated linearly (``np.interp``) onto t_1. numpy in, float out."""
    x_2 = np.asarray(x_2)
    x_interp = np.stack([np.interp(t_1, t_2, x_2[:, i])
                         for i in range(x_2.shape[1])], axis=-1)
    err = np.sum((np.asarray(x_1) - x_interp) ** 2, axis=-1)
    return float(np.sqrt(np.mean(err)))


def quaternion_state_mse(x, x_ref, mask):
    """Weighted error norm between two 13-state quad states, with the
    quaternion geodesic error ``(q q_ref^-1)_xyz`` for the attitude block."""
    mask = torch.as_tensor(mask, dtype=x.dtype, device=x.device)
    q_err = q_dot_q(x[3:7], quaternion_inverse(x_ref[3:7]))
    e = torch.cat([x[:3] - x_ref[:3], q_err[1:], x[7:10] - x_ref[7:10],
                   x[10:] - x_ref[10:]])
    return torch.sqrt(torch.sum((e * mask) ** 2))
