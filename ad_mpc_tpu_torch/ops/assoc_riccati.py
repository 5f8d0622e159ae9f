"""Associative-scan (parallel-prefix) Riccati recursion, batched.

Port of ``ad_mpc_tpu/ops/assoc_riccati.py`` with a leading batch axis, the
layout of :func:`ad_mpc_tpu_torch.ops.riccati.lqr_solve`. The backward
value-function recursion becomes a reverse cumulative combination of
conditional value-function elements (Särkkä & García-Fernández 2021), in
O(log N) dependent steps instead of O(N):

    element k:  A_e = A,  b_e = c - B R^{-1} r,  C_e = B R^{-1} B',
                J = Q,  eta = -q;   terminal (0, 0, 0, -q_N, Q_N)
    combine:    A = A2 (I + C1 J2)^{-1} A1
                b = A2 (I + C1 J2)^{-1} (b1 + C1 eta2) + b2
                C = A2 (I + C1 J2)^{-1} C1 A2' + C2
                eta = A1' (I + J2 C1)^{-1} (eta2 - J2 b1) + eta1
                J = A1' (I + J2 C1)^{-1} J2 A1 + J1

P_k = J_k and p_k = -eta_k then give the gains stage by stage (no
sequential dependency), and the forward rollout is a second scan over
affine-map compositions.

PyTorch has no public associative scan; :func:`associative_scan` follows
``jax.lax.associative_scan``'s odd/even recursion, so the combine tree, and
with it the float32 rounding, is the JAX package's.
"""

from __future__ import annotations

import torch


def _interleave(a, b, dim):
    """a[0], b[0], a[1], b[1], ... along ``dim``; len(a) is len(b) or one more."""
    n = b.shape[dim]
    pairs = torch.stack([a.narrow(dim, 0, n), b], dim=dim + 1)
    out = pairs.flatten(dim, dim + 1)
    if a.shape[dim] > n:
        out = torch.cat([out, a.narrow(dim, n, 1)], dim=dim)
    return out


def _every_other(t, start, dim, stop=None):
    """t[start:stop:2] along ``dim``."""
    idx = [slice(None)] * t.dim()
    idx[dim] = slice(start, stop, 2)
    return t[tuple(idx)]


def associative_scan(fn, elems, reverse=False, dim=0):
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim`` with the
    associative ``fn(earlier, later)``, by ``jax.lax.associative_scan``'s
    recursion: combine neighbouring pairs, scan the half-length sequence,
    then fill in the even positions. ``reverse=True`` flips the sequence,
    scans and flips back, so ``fn`` then receives (later, earlier)."""
    elems = tuple(elems)
    if reverse:
        elems = tuple(e.flip(dim) for e in elems)

    def scan(es):
        n = es[0].shape[dim]
        if n < 2:
            return es
        reduced = fn(tuple(_every_other(e, 0, dim, n - 1) for e in es),
                     tuple(_every_other(e, 1, dim) for e in es))
        odd = scan(tuple(reduced))
        if n % 2 == 0:
            m = odd[0].shape[dim] - 1
            even = fn(tuple(o.narrow(dim, 0, m) for o in odd),
                      tuple(_every_other(e, 2, dim) for e in es))
        else:
            even = fn(odd, tuple(_every_other(e, 2, dim) for e in es))
        even = tuple(torch.cat([e.narrow(dim, 0, 1), r], dim=dim)
                     for e, r in zip(es, even))
        return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))

    out = scan(elems)
    if reverse:
        out = tuple(e.flip(dim) for e in out)
    return out


def _solve(M, Y):
    """M^{-1} Y by LU; ``solve_ex`` leaves the singularity check to the
    caller, so a CUDA solve does not wait for the host."""
    return torch.linalg.solve_ex(M, Y).result


def _combine(e1, e2):
    """Combination of conditional value elements (e1 earlier in time, e2
    later), elementwise over the leading axes. b is (..., nx, 1)."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    nx = A1.shape[-1]
    I = torch.eye(nx, dtype=A1.dtype, device=A1.device)

    M = I + C1 @ J2
    A1_t = _solve(M, A1)
    bC_t = _solve(M, b1 + C1 @ eta2[..., None])
    C1_t = _solve(M, C1)

    A = A2 @ A1_t
    b = A2 @ bC_t + b2
    C = A2 @ C1_t @ A2.transpose(-1, -2) + C2

    Mt = I + J2 @ C1
    eta_t = _solve(Mt, eta2[..., None] - J2 @ b1)
    J_t = _solve(Mt, J2 @ A1)
    A1T = A1.transpose(-1, -2)
    eta = (A1T @ eta_t)[..., 0] + eta1
    J = A1T @ J_t + J1
    J = 0.5 * (J + J.transpose(-1, -2))
    return (A, b, C, eta, J)


def _batched(t, lead):
    """Broadcast ``t`` to the leading batch shape ``lead``."""
    return t.expand(*lead, *t.shape[-3:]) if t.dim() == 3 else t


def backward_pass_assoc(A, Bm, c, Q, q, R, r, reg: float = 0.0):
    """Value-function expansion (P (B,N+1,nx,nx), p (B,N+1,nx)) by one
    reverse associative scan over the stages."""
    nx, nu = Bm.shape[-2], Bm.shape[-1]
    lead = A.shape[:-3]
    Q, R = _batched(Q, lead), _batched(R, lead)
    eye_u = torch.eye(nu, dtype=A.dtype, device=A.device)

    Rreg = R + reg * eye_u
    Rinv_rT = _solve(Rreg, r[..., None])  # (B, N, nu, 1)
    Rinv_BT = _solve(Rreg, Bm.transpose(-1, -2))  # (B, N, nu, nx)

    zeros_m = A.new_zeros(lead + (1, nx, nx))
    elems = (
        torch.cat([A, zeros_m], dim=-3),
        torch.cat([c[..., None] - Bm @ Rinv_rT, A.new_zeros(lead + (1, nx, 1))],
                  dim=-3),
        torch.cat([Bm @ Rinv_BT, zeros_m], dim=-3),
        -q,
        Q,
    )
    # With reverse=True the combine receives (later, earlier): swap into
    # _combine's (earlier, later) order, as the JAX package does.
    _, _, _, eta_all, J_all = associative_scan(
        lambda a, b: _combine(b, a), elems, reverse=True, dim=len(lead))
    return J_all, -eta_all


def gains_from_value(A, Bm, c, Q, q, R, r, P, p, reg: float = 0.0):
    """Per-stage feedback K (B,N,nu,nx) and feedforward k (B,N,nu) from the
    value expansion at k+1, all stages at once."""
    nu = Bm.shape[-1]
    R = _batched(R, A.shape[:-3])
    eye_u = torch.eye(nu, dtype=Bm.dtype, device=Bm.device)
    P_n, p_n = P[..., 1:, :, :], p[..., 1:, :]
    Bt = Bm.transpose(-1, -2)
    H_uu = R + Bt @ P_n @ Bm + reg * eye_u
    H_ux = Bt @ P_n @ A
    h_u = r + (Bt @ (p_n + (P_n @ c[..., None])[..., 0])[..., None])[..., 0]
    L = torch.linalg.cholesky_ex(H_uu).L
    K = -torch.cholesky_solve(H_ux, L)
    kff = -torch.cholesky_solve(h_u[..., None], L)[..., 0]
    return K, kff


def forward_pass_assoc(A, Bm, c, K, kff, dx0):
    """Closed-loop rollout dx_{k+1} = M_k dx_k + m_k, M = A + B K,
    m = B kff + c, as a forward associative scan of affine maps."""
    M = A + Bm @ K
    m = (Bm @ kff[..., None])[..., 0] + c

    def comp(f1, f2):  # f2 after f1: x -> M2 (M1 x + m1) + m2
        M1, m1 = f1
        M2, m2 = f2
        return (M2 @ M1, (M2 @ m1[..., None])[..., 0] + m2)

    Mc, mc = associative_scan(comp, (M, m), dim=A.dim() - 3)
    dx_tail = (Mc @ dx0[..., None, :, None])[..., 0] + mc
    dx = torch.cat([dx0[..., None, :], dx_tail], dim=-2)
    du = (K @ dx[..., :-1, :, None])[..., 0] + kff
    return dx, du


def lqr_solve_assoc(A, Bm, c, Q, q, R, r, dx0, reg: float = 0.0):
    """Drop-in replacement for :func:`ad_mpc_tpu_torch.ops.riccati.lqr_solve`
    with O(log N) sequential depth; returns (dx (B,N+1,nx), du (B,N,nu))."""
    P, p = backward_pass_assoc(A, Bm, c, Q, q, R, r, reg=reg)
    K, kff = gains_from_value(A, Bm, c, Q, q, R, r, P, p, reg=reg)
    return forward_pass_assoc(A, Bm, c, K, kff, dx0)
