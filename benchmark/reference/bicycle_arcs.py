"""Plain reference of the bicycle fleet on constant-curvature arcs.

The 7-state velocity-blended bicycle (state [p_x, p_y, psi, v_x, v_y,
psi_dot, delta], input [a, delta_dot], p = [blend switch]) with linear
tires, and the fleet's tick: project each vehicle onto its arc, build the
reference window along the arc, solve (:func:`ocp.solve`), step the plant
by u0, shift the warm start.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import ocp


def draw(scen: dict, batch: int, seed: int) -> dict:
    """Per-row speed and curvature, float32, from
    ``numpy.random.default_rng(seed)``: v uniform in ``scen["v"]``, kappa
    uniform in [-1, 1] times the least of ``kappa_max`` and
    ``lat_acc_max / v^2``."""
    rng = np.random.default_rng(seed)
    lo, hi = scen["v"]
    v = rng.uniform(lo, hi, batch).astype(np.float32)
    kmax = np.minimum(np.float32(scen["kappa_max"]), np.float32(scen["lat_acc_max"]) / v**2)
    kappa = rng.uniform(-1.0, 1.0, batch).astype(np.float32) * kmax
    return {"v": v, "kappa": kappa.astype(np.float32)}


def dynamics(model: dict):
    """``f(x, u, p)`` of the configuration's ``model`` group, on
    entries-leading tensors."""
    m = {k: float(v) for k, v in model.items() if k != "kind"}
    mass, lf, lr, iz, cf, cr = m["mass"], m["l_f"], m["l_r"], m["iz"], m["cf"], m["cr"]
    wb = lf + lr

    def f(x, u, p):
        psi, vx, vy, r, d = x[2], x[3], x[4], x[5], x[6]
        a, dd = u[0], u[1]
        s = p[0]
        vxs = vx + 1e-6
        ffy = 2.0 * cf * (d - (vy + lf * r) / vxs)
        fry = 2.0 * cr * (lr * r - vy) / vxs
        c, sn = torch.cos(psi), torch.sin(psi)
        cd, sd = torch.cos(d), torch.sin(d)
        vx_dyn = a - ffy * sd / mass + vy * r
        vy_dyn = (fry + ffy * cd) / mass - vx * r
        r_dyn = (lf * ffy * cd - lr * fry) / iz
        vy_kin = (dd * vx + d * a) * lr / wb
        r_kin = (dd * vx + d * a) / wb
        return torch.stack([
            vx * c - vy * sn,
            vx * sn + vy * c,
            r,
            s * vx_dyn + (1 - s) * a,
            s * vy_dyn + (1 - s) * vy_kin,
            s * r_dyn + (1 - s) * r_kin,
            dd,
        ])

    return f


def arc_window(v, kappa, s0, N, dt, wheelbase):
    """(B, N+1, 7) references along the arcs from arc length s0."""
    ar = torch.arange(N + 1, dtype=v.dtype, device=v.device)
    s = s0[:, None] + v[:, None] * ar * dt
    kap = kappa[:, None]
    straight = kap.abs() < 1e-6
    k = torch.where(straight, torch.full_like(kap, 1e-6), kap)
    psi = k * s
    x = torch.where(straight, s, torch.sin(psi) / k)
    y = torch.where(straight, torch.zeros_like(s), (1.0 - torch.cos(psi)) / k)
    ones = torch.ones_like(s)
    return torch.stack([x, y, psi, v[:, None] * ones, torch.zeros_like(s),
                        (kappa * v)[:, None] * ones,
                        torch.atan(kappa * wheelbase)[:, None] * ones], -1)


def project(x0, s0, kappa):
    """Arc length of each vehicle's nearest point on its arc, unwrapped
    near the previous anchor s0."""
    px, py, k = x0[:, 0], x0[:, 1], kappa
    ang = torch.atan2(k * px, 1.0 - k * py)
    ks0 = k * s0
    ang = ks0 + torch.atan2(torch.sin(ang - ks0), torch.cos(ang - ks0))
    straight = k.abs() < 1e-6
    return torch.where(straight, px, ang / torch.where(straight, torch.full_like(k, 1e-6), k))


class Fleet:
    """The reference of one configuration. State of a row: x0 (nx), s0,
    v, kappa, p, warm start xs (N+1, nx), us (N, nu)."""

    def __init__(self, cfg: dict, device, prec: ocp.Precision):
        self.prec = prec
        self.st = ocp.make_stage(cfg["ocp"], device, prec.dtype)
        self.f = dynamics(cfg["model"])
        self.wheelbase = float(cfg["ocp"]["wheelbase_of_reference"])
        self.switch = float(cfg["model"]["switch"])
        self.device = device

    def init(self, draw: dict) -> dict:
        """The fleet's first state from the traffic's draw: each vehicle
        at the start of its arc at its speed, its warm start constant."""
        t = lambda a: torch.as_tensor(a).to(self.device, self.prec.dtype)
        v, kappa = t(draw["v"]), t(draw["kappa"])
        B, N = v.shape[0], self.st.N
        x0 = torch.zeros((B, self.st.nx), dtype=v.dtype, device=self.device)
        x0[:, 3] = v
        return {"x0": x0, "s0": torch.zeros_like(v), "v": v, "kappa": kappa,
                "p": torch.full((B, 1), self.switch, dtype=v.dtype, device=self.device),
                "xs": x0[:, None].expand(B, N + 1, -1).clone(),
                "us": x0.new_zeros((B, N, self.st.nu))}

    def tick(self, s: dict) -> tuple:
        """One tick of every row. Returns (next state, kkt (B,))."""
        st = self.st
        s0 = project(s["x0"], s["s0"], s["kappa"])
        yref = arc_window(s["v"], s["kappa"], s0, st.N, st.dt, self.wheelbase)
        yref_u = torch.zeros_like(s["us"])
        xs, us, kkt = ocp.solve(self.f, st, s["x0"], yref, yref_u, s["p"], s["xs"],
                                s["us"], self.prec)
        x_next = ocp.step(self.f, st.dt, s["x0"], us[:, 0], s["p"])
        xs, us = ocp.shift(xs, us)
        return dict(s, x0=x_next, s0=s0, xs=xs, us=us), kkt
