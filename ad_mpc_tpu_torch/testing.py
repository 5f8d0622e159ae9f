"""Seeded numpy problem generators shared by the tests and ``chip_smoke.py``.

They draw the same LQ batches and bound structures as the JAX package's
kernel tests (``tests/test_pallas_lq.py:21-67``), so a kernel is checked on
the problems its TPU counterpart was checked on.
"""

from __future__ import annotations

import numpy as np


def random_lq(rng, B, N, nx, nu):
    """Batch of random stable LQ problems: float32 A (B,N,nx,nx),
    Bm (B,N,nx,nu), c (B,N,nx), q (B,N+1,nx), r (B,N,nu), u_ref (B,N,nu),
    x_ref (B,N+1,nx)."""
    A = np.eye(nx) + 0.05 * rng.normal(size=(B, N, nx, nx))
    Bm = 0.1 * rng.normal(size=(B, N, nx, nu))
    c = 0.01 * rng.normal(size=(B, N, nx))
    q = rng.normal(size=(B, N + 1, nx))
    r = 0.1 * rng.normal(size=(B, N, nu))
    u_ref = 0.3 * rng.normal(size=(B, N, nu))
    x_ref = 0.3 * rng.normal(size=(B, N + 1, nx))
    return tuple(a.astype(np.float32) for a in (A, Bm, c, q, r, u_ref, x_ref))


def bounds_bicycle_like(nx, nu):
    """Soft input box + one hard state box (the bicycle spec's structure)."""
    u = dict(
        lb=np.array([-10.0, -3.0])[:nu], ub=np.array([5.0, 3.0])[:nu],
        soft=np.ones(nu, bool), zl=np.full(nu, 10.0), zu=np.full(nu, 10.0),
        Zl=np.zeros(nu), Zu=np.zeros(nu),
    )
    lbx, ubx = np.full(nx, -np.inf), np.full(nx, np.inf)
    lbx[-1], ubx[-1] = -0.52, 0.52
    x = dict(lb=lbx, ub=ubx, soft=np.zeros(nx, bool), zl=np.zeros(nx),
             zu=np.zeros(nx), Zl=np.zeros(nx), Zu=np.zeros(nx))
    return u, x


def bounds_hard_unit(nx, nu):
    """[0, 1] hard input box, no state bounds (the quad spec's structure)."""
    u = dict(lb=np.zeros(nu), ub=np.ones(nu), soft=np.zeros(nu, bool),
             zl=np.zeros(nu), zu=np.zeros(nu), Zl=np.zeros(nu), Zu=np.zeros(nu))
    x = dict(lb=np.full(nx, -np.inf), ub=np.full(nx, np.inf),
             soft=np.zeros(nx, bool), zl=np.zeros(nx), zu=np.zeros(nx),
             Zl=np.zeros(nx), Zu=np.zeros(nx))
    return u, x


BOUNDS = {"bicycle": bounds_bicycle_like, "unit": bounds_hard_unit}

# Stage weights of the JAX kernel tests (``tests/test_pallas_lq.py:110-112``).
LQ_WEIGHTS = (np.diag([0.5, 0.5, 2.0, 0.1, 0.0, 0.0, 0.05]),
              np.diag([0.05, 5.0]))


def random_traj(rng, B, N, nx, nu, v0=8.0):
    """float32 iterate (xs (B,N+1,nx), us (B,N,nu)) around speed v0, as
    ``tests/test_pallas_vde.py:39-43`` draws it."""
    xs = rng.normal(0.0, 0.4, (B, N + 1, nx)).astype(np.float32)
    xs[:, :, 3] += v0
    us = rng.normal(0.0, 0.5, (B, N, nu)).astype(np.float32)
    return xs, us
