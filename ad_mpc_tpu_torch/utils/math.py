"""Math helpers (port of ``ad_mpc_tpu/utils/math.py:56-140, 246-256``).

Quaternions are ``[w, x, y, z]`` (Hamilton convention), as in the JAX
package. The quaternion helpers broadcast over leading batch axes; only
those that :func:`ad_mpc_tpu_torch.models.quadrotor.quad_dynamics` needs
are ported.
"""

from __future__ import annotations

import math

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
