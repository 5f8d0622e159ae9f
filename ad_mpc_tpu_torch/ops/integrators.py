"""Explicit RK4 integrators, rollouts and stage linearization.

Port of ``ad_mpc_tpu/ops/integrators.py:17-96``. ``f`` and ``F`` take
entries-leading tensors (``x[i]`` is one state entry), so the same
functions run on single vectors and on batched slabs. Sensitivities come
from ``torch.func.jacfwd`` of the *discretized* map, vmapped over stages:
this is the plain version of the fused VDE kernel (``ops/cuda_vde.py``).
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap


def rk4_step(f, x, u, dt):
    """One classic RK4 step of ``x_dot = f(x, u)``."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def discretize(f, dt, n_steps: int = 1):
    """Discrete map F(x, u) integrating f over dt with ``n_steps`` RK4
    sub-steps."""
    h = dt / n_steps

    def F(x, u):
        for _ in range(n_steps):
            x = rk4_step(f, x, u, h)
        return x

    return F


def discrete_step(f, dt, rk4_steps, x, u, p):
    """RK4 map of ``f(x, u, p)`` on batch-first tensors: x (..., nx),
    u (..., nu), p (..., pd), broadcastable leading axes -> (..., nx)."""
    F = discretize(lambda xx, uu: f(xx, uu, p.movedim(-1, 0)), dt, rk4_steps)
    return F(x.movedim(-1, 0), u.movedim(-1, 0)).movedim(0, -1)


def rollout(F, x0, us):
    """Roll the discrete map over a control sequence: (nx,), (N, nu) ->
    states (N+1, nx)."""
    xs = [x0]
    for u in us:
        xs.append(F(xs[-1], u))
    return torch.stack(xs)


def linearize(F, xs, us):
    """Stage-wise linearization of the discrete dynamics along a trajectory.

    Returns (A, B, c) with shapes (N, nx, nx), (N, nx, nu), (N, nx) where
        x_{k+1} ~ A_k dx_k + B_k du_k + c_k,  c_k = F(x_k, u_k) - x_{k+1}.
    """
    xk = xs[:-1]
    # jacfwd promotes the tangent of a 0-dim entry times a Python float to
    # float64; the Jacobians are returned in the iterate's dtype.
    A = vmap(jacfwd(F, argnums=0))(xk, us).to(xs.dtype)
    B = vmap(jacfwd(F, argnums=1))(xk, us).to(xs.dtype)
    c = vmap(F)(xk, us) - xs[1:]
    return A, B, c
