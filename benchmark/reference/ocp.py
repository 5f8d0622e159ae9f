"""The plain SQP-RTI solve the benchmark holds the port to.

A frozen, independent copy of the algorithm the configurations state: the
RK4 map, its stage linearization by automatic differentiation (one
reverse-mode pass per state entry), the linear-least-squares gradients, the
fixed-iteration primal-dual interior-point method for the box-constrained
LQ subproblem with its Riccati step, the KKT defect and the warm-start
shift. Plain PyTorch on batch-first tensors, in any dtype; it imports
nothing of the system under test.

:class:`Precision` says how it computes. ``float64`` is the reference. The
control, the step below the float32 that the configurations state, is
``float32`` with ``tf32=True``: every matrix product rounds its operands to
TF32 (10 explicit mantissa bits, round to nearest) and accumulates in
float32, as a tensor core does. On a CUDA device the products themselves
run with TF32 off, so only the emulated rounding acts.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Precision(NamedTuple):
    dtype: torch.dtype = torch.float64
    tf32: bool = False


REFERENCE = Precision(torch.float64, False)
CONTROL = Precision(torch.float32, True)


def tf32_round(x):
    """float32 ``x`` rounded to TF32: the low 13 mantissa bits cleared,
    rounding to nearest (ties away from zero, as ``cvt.rna.tf32.f32``)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a, b, prec: Precision):
    """``a @ b`` in ``prec``."""
    if prec.tf32:
        a, b = tf32_round(a.to(torch.float32)), tf32_round(b.to(torch.float32))
    return a @ b


def mv(M, v, prec: Precision):
    return mm(M, v.unsqueeze(-1), prec).squeeze(-1)


class Stage(NamedTuple):
    """The OCP of a configuration, as its file states it."""

    N: int
    dt: float
    nx: int
    nu: int
    Q: torch.Tensor  # (nx, nx), stage weights scaled by dt
    R: torch.Tensor  # (nu, nu)
    QN: torch.Tensor  # (nx, nx)
    bounds: tuple  # (lb, ub, soft, z, Z) of the inputs, then of the states
    qp_iters: int
    sqp_iters: int
    levenberg: float
    tau_min: float
    yaw_wrap_idx: int | None


def make_stage(ocp: dict, device, dtype) -> Stage:
    """The :class:`Stage` of a configuration file's ``ocp`` group."""
    N, tf = int(ocp["n_nodes"]), float(ocp["t_horizon"])
    dt = tf / N
    t = lambda v: torch.as_tensor(v, dtype=torch.float64).to(device=device, dtype=dtype)
    Q = torch.diag(t(ocp["q_cost"])) * dt
    R = torch.diag(t(ocp["r_cost"])) * dt
    QN = torch.diag(t(ocp["w_e_cost"]))
    inf = float("inf")

    def group(lb, ub, soft, z, Z, n):
        lb = [-inf if v is None else float(v) for v in (lb or [None] * n)]
        ub = [inf if v is None else float(v) for v in (ub or [None] * n)]
        soft = [bool(s) for s in (soft or [False] * n)]
        zs = [float(z) if s else 0.0 for s in soft]
        Zs = [float(Z) if s else 0.0 for s in soft]
        return (t(lb), t(ub), torch.as_tensor(soft, device=device), t(zs), t(Zs))

    nx, nu = int(ocp["nx"]), int(ocp["nu"])
    u = group(ocp.get("lbu"), ocp.get("ubu"), ocp.get("soft_u"), ocp.get("zl_u", 0.0),
              ocp.get("Zl_u", 0.0), nu)
    x = group(ocp.get("lbx"), ocp.get("ubx"), None, 0.0, 0.0, nx)
    return Stage(N, dt, nx, nu, Q, R, QN, (u, x), int(ocp["qp_iters"]),
                 int(ocp["sqp_iters"]), float(ocp["levenberg"]),
                 float(ocp["tau_min"]), ocp.get("yaw_wrap_idx"))


# ------------------------------------------------------------ integration


def rk4(f, x, u, dt):
    """One RK4 step of ``x_dot = f(x, u)`` on entries-leading tensors."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def step(f, dt, x, u, p):
    """The RK4 map on batch-first rows: x (M, nx), u (M, nu), p (M, pd)."""
    pt = p.movedim(-1, 0)
    return rk4(lambda xx, uu: f(xx, uu, pt), x.movedim(-1, 0), u.movedim(-1, 0),
               dt).movedim(0, -1)


def linearize(f, dt, xs, us, p):
    """(A (B,N,nx,nx), Bm (B,N,nx,nu), c (B,N,nx)) of the RK4 map along
    each row's trajectory: row i of every stage's Jacobian [A | Bm] is the
    gradient of the sum over stages of the map's entry i (stages are
    independent of one another), one reverse-mode pass per state entry;
    c = F(x_k, u_k) - x_{k+1}."""
    B, N, nx = xs.shape[0], us.shape[1], xs.shape[-1]
    nu = us.shape[-1]
    M = B * N
    x = xs[:, :-1].reshape(M, nx).T.detach().requires_grad_(True)  # entries leading
    u = us.reshape(M, nu).T.detach().requires_grad_(True)
    pk = p[:, None].expand(B, N, p.shape[-1]).reshape(M, -1).T
    with torch.enable_grad():
        y = rk4(lambda xx, uu: f(xx, uu, pk), x, u, dt)  # (nx, M)
        rows = [torch.cat(torch.autograd.grad(y[i].sum(), (x, u), retain_graph=i < nx - 1))
                for i in range(nx)]
    J = torch.stack(rows).permute(2, 0, 1).reshape(B, N, nx, nx + nu)
    c = y.detach().T - xs[:, 1:].reshape(M, nx)
    return J[..., :nx], J[..., nx:], c.reshape(B, N, nx)


# ------------------------------------------------------------ LQ subproblem


def chol_solve(H, rhs):
    """X with H X = rhs for symmetric positive definite H (..., n, n),
    rhs (..., n, m): the Cholesky factor and the two triangular solves
    written out entry by entry (n is an input count, 2 or 4), so that a
    batch of small systems costs a few elementwise operations. A
    non-positive pivot gives non-finite entries."""
    n = H.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = H[..., j, j] - sum(L[j][k] * L[j][k] for k in range(j))
        L[j][j] = torch.sqrt(d)
        for i in range(j + 1, n):
            L[i][j] = (H[..., i, j] - sum(L[i][k] * L[j][k] for k in range(j))) / L[j][j]
    y = [None] * n
    for i in range(n):
        acc = rhs[..., i, :]
        for k in range(i):
            acc = acc - L[i][k][..., None] * y[k]
        y[i] = acc / L[i][i][..., None]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - L[k][i][..., None] * x[k]
        x[i] = acc / L[i][i][..., None]
    return torch.stack(x, -2)


def riccati(A, Bm, Q, q, R, r, reg, prec):
    """The equality-constrained LQ step from dx0 = 0 with homogeneous
    dynamics (the IPM's Newton step): the backward Riccati sweep, then the
    forward rollout of du = K dx + k. Q (B,N+1,nx,nx), R (B,N,nu,nu)."""
    N, nu = Bm.shape[1], Bm.shape[-1]
    eye = torch.eye(nu, dtype=A.dtype, device=A.device)
    P, p = Q[:, N], q[:, N]
    Ks, ks = [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        Ak, Bk = A[:, k], Bm[:, k]
        At, Bt = Ak.transpose(-1, -2), Bk.transpose(-1, -2)
        PA, PB = mm(P, Ak, prec), mm(P, Bk, prec)
        Huu = R[:, k] + mm(Bt, PB, prec) + reg * eye
        Hux = mm(Bt, PA, prec)
        hu = r[:, k] + mv(Bt, p, prec)
        X = -chol_solve(Huu, torch.cat([Hux, hu.unsqueeze(-1)], -1))
        K, kf = X[..., :-1], X[..., -1]
        P = Q[:, k] + mm(At, PA, prec) + mm(Hux.transpose(-1, -2), K, prec)
        P = 0.5 * (P + P.transpose(-1, -2))
        p = q[:, k] + mv(At, p, prec) + mv(Hux.transpose(-1, -2), kf, prec)
        Ks[k], ks[k] = K, kf
    dx = [torch.zeros_like(q[:, 0])]
    du = []
    for k in range(N):
        u = mv(Ks[k], dx[-1], prec) + ks[k]
        dx.append(mv(A[:, k], dx[-1], prec) + mv(Bm[:, k], u, prec))
        du.append(u)
    return torch.stack(dx, 1), torch.stack(du, 1)


def _side(v, bound, cone, tau, lo):
    """Elimination of one side of one bound group: the diagonal weight w,
    the gradient term and what the back-substitution needs."""
    lb, ub, softb, zl, Zl = bound
    b = lb if lo else ub
    mask = torch.isfinite(b)
    soft = softb & mask
    hard = mask & ~softb
    t, lam, sig, mu = cone
    gap = (v - b) if lo else (b - v)
    zero = torch.zeros_like(v)
    rp = gap + torch.where(soft, sig, zero) - t
    r1 = lam * t - tau + lam * rp
    r2 = mu * sig - tau
    r3 = zl + Zl * sig - lam - mu
    lt = lam / t
    D = Zl + lt + mu / sig
    w = torch.where(soft, lt * (1.0 - lt / D), torch.where(hard, lt, zero))
    w = torch.clamp(w, max=1e6 if v.dtype == torch.float32 else 1e12)
    g = torch.where(soft, -r1 / t + lt * (r3 + r1 / t + r2 / sig) / D,
                    torch.where(hard, -r1 / t, zero))
    grad = torch.where(mask, (-1.0 if lo else 1.0) * (lam + g), zero)
    return w, grad, (r1, r2, r3, rp, D, lt, mask, soft)


def _cone_step(dv, cone, cache, lo):
    r1, r2, r3, rp, D, lt, mask, soft = cache
    t, lam, sig, mu = cone
    s = 1.0 if lo else -1.0
    zero = torch.zeros_like(dv)
    dsig = torch.where(soft, (-r3 - r1 / t - r2 / sig - s * lt * dv) / D, zero)
    dlam = torch.where(mask, -r1 / t - lt * (s * dv + dsig), zero)
    dmu = torch.where(soft, (-r2 - mu * dsig) / sig, zero)
    dt = torch.where(mask, s * dv + dsig + rp, zero)
    return (dt, dlam, dsig, dmu)


def lq_ipm(A, Bm, c, q, r, u_ref, x_ref, st: Stage, prec: Precision):
    """The box-constrained LQ subproblem by ``st.qp_iters`` primal-dual
    interior-point iterations from the feasible start du = 0, dx the defect
    propagation; bounds on the absolute u_ref + du and x_ref + dx (states at
    stages 1..N). Returns (dx (B,N+1,nx), du (B,N,nu))."""
    Bsz, N, nx, nu = A.shape[0], st.N, st.nx, st.nu
    dt_, dev = A.dtype, A.device
    dxs = [torch.zeros((Bsz, nx), dtype=dt_, device=dev)]
    for k in range(N):
        dxs.append(mv(A[:, k], dxs[-1], prec) + c[:, k])
    dx = torch.stack(dxs, 1)
    du = torch.zeros((Bsz, N, nu), dtype=dt_, device=dev)
    ub, xb = st.bounds
    groups = ((ub, True), (ub, False), (xb, True), (xb, False))

    def init(v, bound, lo):
        lb, ubd, softb, _, _ = bound
        b = lb if lo else ubd
        mask = torch.isfinite(b).expand_as(v)
        gap = (v - b) if lo else (b - v)
        soft = softb.expand_as(v) & mask
        one = torch.ones_like(v)
        sig = torch.where(soft, torch.clamp(0.1 - gap, min=0.1), one)
        t = torch.where(mask, torch.where(soft, gap + sig, torch.clamp(gap, min=0.1)), one)
        lam = torch.where(mask, torch.full_like(v, 0.1), one)
        mu = torch.where(soft, torch.full_like(v, 0.1), one)
        return (t, lam, sig, mu)

    cones = [init(u_ref + du if i < 2 else (x_ref + dx)[:, 1:], b, lo)
             for i, (b, lo) in enumerate(groups)]
    tau = torch.full((Bsz, 1, 1), 0.1, dtype=dt_, device=dev)
    Qs = torch.cat([st.Q.expand(N, nx, nx), st.QN[None]], 0).to(dt_).expand(Bsz, -1, -1, -1)
    Rs = st.R.to(dt_).expand(Bsz, N, nu, nu)
    zero_row = torch.zeros_like(dx[:, :1])
    # Which cone entries are bounds, and how many (stage, entry) pairs the
    # barrier's centering averages over.
    masks, count = [], 0
    for cn, (b, lo) in zip(cones, groups):
        mask = torch.isfinite(b[0] if lo else b[1]).expand_as(cn[0])
        soft = b[2].expand_as(cn[0]) & mask
        masks.append((mask, soft))
        count += int(mask[0].sum()) + int(soft[0].sum())
    for _ in range(st.qp_iters):
        ua, xa = u_ref + du, x_ref + dx
        terms = [_side(ua if i < 2 else xa[:, 1:], b, cones[i], tau, lo)
                 for i, (b, lo) in enumerate(groups)]
        Rm = Rs + torch.diag_embed(terms[0][0] + terms[1][0])
        rm = mv(Rs, du, prec) + r + terms[0][1] + terms[1][1]
        wx = torch.cat([zero_row, terms[2][0] + terms[3][0]], 1)
        gx = torch.cat([zero_row, terms[2][1] + terms[3][1]], 1)
        Qm = Qs + torch.diag_embed(wx)
        qm = mv(Qs, dx, prec) + q + gx
        ddx, ddu = riccati(A, Bm, Qm, qm, Rm, rm, st.levenberg, prec)
        dcones = [_cone_step(ddu if i < 2 else ddx[:, 1:], cones[i], terms[i][2], lo)
                  for i, (_, lo) in enumerate(groups)]
        alphas = []
        for cn, dcn in zip(cones, dcones):
            for v, dv in zip(cn, dcn):
                neg = dv < 0
                ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                                    torch.full_like(v, math.inf))
                alphas.append(ratio.flatten(1).min(1).values)
        alpha = torch.clamp(0.995 * torch.stack(alphas).min(0).values, max=1.0)
        al = alpha[:, None, None]
        dx, du = dx + al * ddx, du + al * ddu
        cones = [tuple(torch.clamp(v + al * dv, min=1e-10) for v, dv in zip(cn, dcn))
                 for cn, dcn in zip(cones, dcones)]
        total = 0.0
        for cn, (mask, soft) in zip(cones, masks):
            z = torch.zeros_like(cn[0])
            total = total + (torch.where(mask, cn[0] * cn[1], z)
                             + torch.where(soft, cn[2] * cn[3], z)).flatten(1).sum(1)
        tau = torch.clamp(0.1 * total / max(count, 1), min=st.tau_min)[:, None, None]
    return dx, du


# ------------------------------------------------------------ the solve


def yaw_wrap(psi_ref, psi0):
    """The yaw reference moved by 2 pi toward the state's yaw, as ACADOS's
    wrap rule does it."""
    down = (psi0 < 0) & (psi0 + math.pi < psi_ref)
    up = (psi0 > 0) & (psi0 - math.pi > psi_ref)
    return psi_ref - 2 * math.pi * down.to(psi_ref.dtype) + 2 * math.pi * up.to(psi_ref.dtype)


def solve(f, st: Stage, x0, yref_x, yref_u, p, xs, us, prec: Precision):
    """``st.sqp_iters`` Gauss-Newton iterations from the warm start (xs,
    us) with xs[0] = x0. Returns (xs, us, kkt): the iterate and the RMS of
    its multiple-shooting defect per row."""
    if st.yaw_wrap_idx is not None:
        i = st.yaw_wrap_idx
        yref_x = yref_x.clone()
        yref_x[:, :, i] = yaw_wrap(yref_x[:, :, i], x0[:, i, None])
    for _ in range(st.sqp_iters):
        xs = xs.clone()
        xs[:, 0] = x0
        A, Bm, c = linearize(f, st.dt, xs, us, p)
        ex = xs - yref_x
        q = torch.cat([mv(st.Q, ex[:, :-1], prec), mv(st.QN, ex[:, -1], prec)[:, None]], 1)
        r = mv(st.R, us - yref_u, prec)
        dx, du = lq_ipm(A, Bm, c, q, r, us, xs, st, prec)
        xs, us = xs + dx, us + du
    B, N = us.shape[:2]
    pk = p[:, None].expand(B, N, p.shape[-1])
    defect = step(f, st.dt, xs[:, :-1], us, pk) - xs[:, 1:]
    return xs, us, torch.sqrt(torch.mean(defect ** 2, dim=(1, 2)))


def shift(xs, us):
    """The RTI warm start of the next tick: every stage moved one forward,
    the last repeated."""
    return (torch.cat([xs[:, 1:], xs[:, -1:]], 1), torch.cat([us[:, 1:], us[:, -1:]], 1))
