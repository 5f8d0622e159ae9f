"""Batched primal-dual interior-point method for box-constrained LQ OCPs.

Port of ``ad_mpc_tpu/ops/qp_ipm.py:46-321`` with a leading batch axis. It is
the plain version of the fused LQ kernel (``ops/cuda_lq.py``): the same cone
eliminations, Riccati step, fraction-to-boundary rule and centering.

Every inequality is a (possibly soft) box bound on one input or state entry.
Each iteration eliminates the bound duals/slacks into diagonal Hessian and
gradient terms, then takes the Newton step with one Riccati sweep
(:mod:`ad_mpc_tpu_torch.ops.riccati`). Soft lower bound on scalar v:
    v - l + sigma >= 0 (slack t, dual lam), sigma >= 0 (dual mu),
    cost z*sigma + 0.5*Z*sigma^2
Eliminating (dt, dsigma, dmu) gives with D = Z + lam/t + mu/sigma the
diagonal weight lam/t * (1 - lam/(t*D)) and a gradient term; upper bounds
mirror with flipped signs; hard bounds drop sigma.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ad_mpc_tpu_torch.ops.riccati import lqr_solve


class BoundSpec(NamedTuple):
    """Box bounds for one variable group. All tensors have the group's width
    (nu or nx). Infinite entries in lb/ub disable the bound; ``soft`` marks
    entries whose bound may be violated at cost ``zl/zu`` (+ ``Zl/Zu``)."""

    lb: torch.Tensor
    ub: torch.Tensor
    soft: torch.Tensor  # bool
    zl: torch.Tensor
    zu: torch.Tensor
    Zl: torch.Tensor
    Zu: torch.Tensor


class _Cone(NamedTuple):
    """IPM variables for one side of one bound group, (B, S, width).
    Masked-out entries idle at 1."""

    t: torch.Tensor  # slack > 0
    lam: torch.Tensor  # bound dual > 0
    sigma: torch.Tensor  # soft violation slack > 0 (soft only)
    mu: torch.Tensor  # dual of sigma >= 0 (soft only)


def _init_cone(v, bound, lo: bool, t0: float, lam0: float):
    """Strictly-interior start. v: (B, S, n) current variable values."""
    b = bound.lb if lo else bound.ub
    mask = torch.isfinite(b).expand_as(v)
    gap = (v - b) if lo else (b - v)
    soft = bound.soft.expand_as(v) & mask
    one = torch.ones_like(v)
    # sigma covers any initial violation so t starts interior.
    sigma = torch.where(soft, torch.clamp(t0 - gap, min=t0), one)
    t = torch.where(mask, torch.where(soft, gap + sigma,
                                      torch.clamp(gap, min=t0)), one)
    lam = torch.where(mask, torch.full_like(v, lam0), one)
    mu = torch.where(soft, torch.full_like(v, lam0), one)
    return _Cone(t=t, lam=lam, sigma=sigma, mu=mu)


def _cone_terms(v, bound, cone: _Cone, tau, lo: bool):
    """Per-entry diagonal Hessian weight w (>= 0) and gradient contribution
    for the Riccati step, plus cached elimination coefficients. ``tau`` is
    (B, 1, 1)."""
    b = bound.lb if lo else bound.ub
    mask = torch.isfinite(b)
    soft = bound.soft & mask
    hard = mask & ~bound.soft

    t, lam, sigma, mu = cone
    gap = (v - b) if lo else (b - v)
    zero = torch.zeros_like(v)

    rp = gap + torch.where(soft, sigma, zero) - t
    r1 = lam * t - tau + lam * rp
    r2 = mu * sigma - tau
    z = bound.zl if lo else bound.zu
    Z = bound.Zl if lo else bound.Zu
    r3 = z + Z * sigma - lam - mu

    lam_t = lam / t
    D = Z + lam_t + mu / sigma
    # Weight cap: beyond 1e6 (f32) the bound is already infinitely stiff,
    # while uncapped weights make the f32 Riccati cancellation lose
    # PSD-ness of the value Hessian and NaN the Cholesky.
    w_soft = lam_t * (1.0 - lam_t / D)
    w = torch.where(soft, w_soft, torch.where(hard, lam_t, zero))
    w_cap = 1e6 if t.dtype == torch.float32 else 1e12
    w = torch.clamp(w, max=w_cap)

    g_soft = -r1 / t + lam_t * (r3 + r1 / t + r2 / sigma) / D
    g_hard = -r1 / t
    g = torch.where(soft, g_soft, torch.where(hard, g_hard, zero))

    sgn = -1.0 if lo else 1.0
    grad = torch.where(mask, sgn * (lam + g), zero)
    return w, grad, (r1, r2, r3, rp, D, lam_t, mask, soft)


def _cone_step(dv, cone: _Cone, cache, lo: bool):
    """Newton step of the cone variables given the primal step dv
    (back-substitution of the elimination)."""
    r1, r2, r3, rp, D, lam_t, mask, soft = cache
    t, lam, sigma, mu = cone
    s = 1.0 if lo else -1.0  # d(gap)/d(v)
    zero = torch.zeros_like(dv)

    dsigma = torch.where(
        soft, (-r3 - r1 / t - r2 / sigma - s * lam_t * dv) / D, zero
    )
    dlam = torch.where(mask, -r1 / t - lam_t * (s * dv + dsigma), zero)
    dmu = torch.where(soft, (-r2 - mu * dsigma) / sigma, zero)
    dt = torch.where(mask, s * dv + dsigma + rp, zero)
    return _Cone(t=dt, lam=dlam, sigma=dsigma, mu=dmu)


def _fraction_to_boundary(cone: _Cone, dcone: _Cone, frac=0.995):
    """Per-scenario max step keeping all positive variables positive."""

    def ratio(v, dv):
        neg = dv < 0
        r = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, float("inf")))
        return r.flatten(1).min(dim=1).values

    alphas = torch.stack([ratio(v, dv) for v, dv in zip(cone, dcone)])
    return torch.clamp(frac * alphas.min(dim=0).values, max=1.0)


def _cone_complementarity(cone: _Cone, bound, lo: bool):
    b = bound.lb if lo else bound.ub
    # The count runs over (stages, width) pairs like the numerator: a
    # per-entry count would turn centering into barrier growth.
    mask = torch.isfinite(b).expand_as(cone.t)
    soft = bound.soft.expand_as(cone.t) & mask
    zero = torch.zeros_like(cone.t)
    comp = torch.where(mask, cone.t * cone.lam, zero) + torch.where(
        soft, cone.sigma * cone.mu, zero
    )
    count = int(mask[0].sum()) + int(soft[0].sum())  # (stages, width) pairs
    return comp.flatten(1).sum(dim=1), count


def solve_lq_ocp(
    A, B, c, Q, q, R, r, dx0,
    u_bounds: BoundSpec, x_bounds: BoundSpec,
    u_ref, x_ref,
    iters: int = 18,
    tau_min: float = 1e-8,
    reg: float = 1e-8,
    lqr_fn=lqr_solve,
):
    """Solve a batch of box-constrained LQ OCPs with a fixed-iteration
    primal-dual IPM.

    Bounds act on the absolute variables ``u_ref + du`` and ``x_ref + dx``;
    state bounds apply to stages 1..N. ``lqr_fn`` solves the Newton step's
    LQ problem: the sequential :func:`lqr_solve` or
    :func:`ad_mpc_tpu_torch.ops.assoc_riccati.lqr_solve_assoc`. Returns (dx (B,N+1,nx), du (B,N,nu),
    stats) with ``stats["alpha"]`` of shape (iters, B).
    """
    N = A.shape[-3]
    nu = B.shape[-1]
    dtype = A.dtype

    # Initial primal iterate: du = 0, dx = defect propagation (feasible).
    dxs = [dx0]
    for k in range(N):
        dxs.append((A[:, k] @ dxs[-1].unsqueeze(-1)).squeeze(-1) + c[:, k])
    dx = torch.stack(dxs, dim=1)
    du = torch.zeros(B.shape[:-3] + (N, nu), dtype=dtype, device=A.device)

    groups = ((u_bounds, True), (u_bounds, False),
              (x_bounds, True), (x_bounds, False))
    t0, lam0 = 0.1, 0.1
    u_abs, x_abs = u_ref + du, x_ref + dx
    cones = tuple(
        _init_cone(u_abs if i < 2 else x_abs[:, 1:], b, lo, t0, lam0)
        for i, (b, lo) in enumerate(groups)
    )
    tau = torch.full((A.shape[0], 1, 1), 0.1, dtype=dtype, device=A.device)
    zeros_c = torch.zeros_like(c)
    zero_row = torch.zeros_like(dx[:, :1])
    alphas = []

    for _ in range(iters):
        u_abs, x_abs = u_ref + du, x_ref + dx
        terms = [
            _cone_terms(u_abs if i < 2 else x_abs[:, 1:], b, cones[i], tau, lo)
            for i, (b, lo) in enumerate(groups)
        ]
        (wu_l, gu_l, _), (wu_h, gu_h, _), (wx_l, gx_l, _), (wx_h, gx_h, _) = terms

        # Modified cost for the Newton/Riccati step.
        R_mod = R + torch.diag_embed(wu_l + wu_h)
        r_mod = (R @ du.unsqueeze(-1)).squeeze(-1) + r + gu_l + gu_h
        wx = torch.cat([zero_row, wx_l + wx_h], dim=1)
        gx = torch.cat([zero_row, gx_l + gx_h], dim=1)
        Q_mod = Q + torch.diag_embed(wx)
        q_mod = (Q @ dx.unsqueeze(-1)).squeeze(-1) + q + gx

        # Newton step: homogeneous dynamics (the iterate is feasible).
        ddx, ddu = lqr_fn(A, B, zeros_c, Q_mod, q_mod, R_mod, r_mod,
                          torch.zeros_like(dx0), reg=reg)

        dcones = [
            _cone_step(ddu if i < 2 else ddx[:, 1:], cones[i], terms[i][2], lo)
            for i, (_, lo) in enumerate(groups)
        ]
        alpha = torch.stack(
            [_fraction_to_boundary(cn, dcn) for cn, dcn in zip(cones, dcones)]
        ).min(dim=0).values
        al = alpha[:, None, None]

        dx = dx + al * ddx
        du = du + al * ddu
        # Positivity floor: f32 rounding can zero a tiny slack at
        # convergence, making the next mu/sigma division non-finite.
        floor = 1e-10
        cones = tuple(
            _Cone(*(torch.clamp(v + al * dv, min=floor)
                    for v, dv in zip(cn, dcn)))
            for cn, dcn in zip(cones, dcones)
        )

        # Barrier update: centering on the current complementarity.
        sums = [_cone_complementarity(cn, b, lo)
                for cn, (b, lo) in zip(cones, groups)]
        total = sum(s for s, _ in sums)
        count = sum(n for _, n in sums)
        tau = torch.clamp(0.1 * total / max(count, 1), min=tau_min)
        tau = tau.to(dtype)[:, None, None]
        alphas.append(alpha)

    stats = {"alpha": torch.stack(alphas), "tau": tau[:, 0, 0]}
    return dx, du, stats
