"""Uncertainty-aware forward propagation and plant rollouts.

Port of ``ad_mpc_tpu/ocp/propagation.py``:

- :func:`forward_prop`: the EKF-style mean and covariance rollout along a
  control sequence, with the learned residual's predictive variance
  injected through a selection matrix;
- :func:`simulate_plant`: the plant stepped one control period per input;
- :func:`reshape_input_sequence`.

JAX's ``lax.scan`` over the stages becomes a loop on the tensors' device;
each stage's Jacobian comes from ``torch.func.jacfwd`` of the
RK4-discretized dynamics, the linearization the solver's plain version
uses.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import jacfwd

from ad_mpc_tpu_torch.ops.integrators import discretize


def forward_prop(dynamics: Callable, x0, us, dt: float, P0=None, process_noise=None,
                 rk4_steps: int = 1, residual_var_fn: Optional[Callable] = None,
                 residual_select=None):
    """Propagate the mean and covariance through the discretized dynamics.

    ``dynamics(x, u) -> x_dot`` (continuous time); x0 (nx,), us (N, nu);
    P0 (nx, nx), default zero; ``process_noise`` W (nx, nx) added at each
    stage; ``residual_var_fn(x, u) -> (m,)`` the learned residual's
    variance per second squared, mapped into the state by
    ``residual_select`` (nx, m) and scaled by dt^2:
    ``P' = A P A^T + W + dt^2 Bx diag(var) Bx^T``.
    Returns (xs (N+1, nx), Ps (N+1, nx, nx)).
    """
    x0 = torch.as_tensor(x0)
    us = torch.as_tensor(us, dtype=x0.dtype, device=x0.device)
    nx = x0.shape[0]
    zeros = lambda: torch.zeros((nx, nx), dtype=x0.dtype, device=x0.device)
    P0 = zeros() if P0 is None else torch.as_tensor(P0, dtype=x0.dtype, device=x0.device)
    W = (zeros() if process_noise is None
         else torch.as_tensor(process_noise, dtype=x0.dtype, device=x0.device))
    F = discretize(dynamics, dt, rk4_steps)
    if residual_select is not None:
        Bx = torch.as_tensor(residual_select, dtype=x0.dtype, device=x0.device)

    xs, Ps = [x0], [P0]
    x, P = x0, P0
    for u in us:
        A = jacfwd(F, argnums=0)(x, u).to(x0.dtype)
        x_next = F(x, u)
        P_next = A @ P @ A.T + W
        if residual_var_fn is not None:
            var = torch.as_tensor(residual_var_fn(x, u), dtype=x0.dtype,
                                  device=x0.device)
            P_next = P_next + (dt * dt) * (Bx * var[None, :]) @ Bx.T
        x, P = x_next, P_next
        xs.append(x)
        Ps.append(P)
    return torch.stack(xs), torch.stack(Ps)


def simulate_plant(sim, x0, us, control_period: float, generator=None):
    """Step the plant ``sim`` (``QuadrotorSim``) one control period per
    input row, drawing its noise from ``generator`` (default: the
    simulator's own): (N+1, nx) states, x0 first."""
    xs = [torch.as_tensor(x0)]
    for u in torch.as_tensor(us):
        xs.append(sim.step(xs[-1], u, control_period, generator=generator))
    return torch.stack(xs)


def reshape_input_sequence(u_flat, nu: int):
    """Flattened inputs (N*nu,) -> (N, nu)."""
    return torch.as_tensor(u_flat).reshape(-1, nu)
