"""Batched Riccati recursion for the equality-constrained LQ subproblem.

Port of ``ad_mpc_tpu/ops/riccati.py:31-89`` with a leading batch axis and
the stage recursion as a Python loop. Solves, per scenario,
    min  sum_k (0.5 dx'Q_k dx + q_k'dx + 0.5 du'R_k du + r_k'du)
         + 0.5 dx_N'Q_N dx_N + q_N'dx_N
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + c_k,   dx_0 = dx0 (fixed)

Shapes: A (B,N,nx,nx), Bm (B,N,nx,nu), c (B,N,nx), Q (B,N+1,nx,nx),
q (B,N+1,nx), R (B,N,nu,nu), r (B,N,nu), dx0 (B,nx). Q and R may drop the
batch axis (they broadcast).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LQRGains(NamedTuple):
    K: torch.Tensor  # (B, N, nu, nx) feedback
    k: torch.Tensor  # (B, N, nu) feedforward


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def backward_pass(A, Bm, c, Q, q, R, r, reg: float = 0.0):
    """Backward Riccati sweep. Returns gains and the value-function
    expansion (P, p) at every stage. ``reg`` adds Levenberg-style diagonal
    regularization to the input Hessian before factorization."""
    N, nu = Bm.shape[-3], Bm.shape[-1]
    eye_u = torch.eye(nu, dtype=Bm.dtype, device=Bm.device)
    P, p = Q[..., N, :, :], q[..., N, :]
    Ks, ks, Ps, ps = [None] * N, [None] * N, [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        A_k, B_k, c_k = A[..., k, :, :], Bm[..., k, :, :], c[..., k, :]
        At, Bt = A_k.transpose(-1, -2), B_k.transpose(-1, -2)
        PA = P @ A_k
        PB = P @ B_k
        pc = p + _mv(P, c_k)

        H_uu = R[..., k, :, :] + Bt @ PB + reg * eye_u
        H_ux = Bt @ PA
        h_u = r[..., k, :] + _mv(Bt, pc)

        # cholesky_ex: no host sync for the error check; a non-positive
        # H_uu gives non-finite gains, as in the JAX package.
        L = torch.linalg.cholesky_ex(H_uu).L
        K = -torch.cholesky_solve(H_ux, L)
        kff = -torch.cholesky_solve(h_u.unsqueeze(-1), L).squeeze(-1)

        # Symmetrized value-function update.
        P = Q[..., k, :, :] + At @ PA + H_ux.transpose(-1, -2) @ K
        P = 0.5 * (P + P.transpose(-1, -2))
        p = q[..., k, :] + _mv(At, pc) + _mv(H_ux.transpose(-1, -2), kff)
        Ks[k], ks[k], Ps[k], ps[k] = K, kff, P, p
    gains = LQRGains(torch.stack(Ks, dim=-3), torch.stack(ks, dim=-2))
    return gains, (torch.stack(Ps, dim=-3), torch.stack(ps, dim=-2))


def forward_pass(A, Bm, c, gains: LQRGains, dx0):
    """Forward rollout of the affine policy du = K dx + k through the
    linearized dynamics."""
    N = A.shape[-3]
    dxs, dus = [dx0], []
    for k in range(N):
        du = _mv(gains.K[..., k, :, :], dxs[-1]) + gains.k[..., k, :]
        dxs.append(
            _mv(A[..., k, :, :], dxs[-1]) + _mv(Bm[..., k, :, :], du)
            + c[..., k, :]
        )
        dus.append(du)
    return torch.stack(dxs, dim=-2), torch.stack(dus, dim=-2)


def lqr_solve(A, Bm, c, Q, q, R, r, dx0, reg: float = 0.0):
    """Solve the LQ problem; returns (dx (B,N+1,nx), du (B,N,nu))."""
    gains, _ = backward_pass(A, Bm, c, Q, q, R, r, reg=reg)
    return forward_pass(A, Bm, c, gains, dx0)
