"""Math helpers (port of ``ad_mpc_tpu/utils/math.py:246-256``)."""

from __future__ import annotations

import math

import torch


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
