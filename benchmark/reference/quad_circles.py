"""Plain reference of the quadrotor fleet on horizontal circles.

The 13-state quadrotor (position, unit quaternion [w, x, y, z], world
velocity, body rates; 4 normalized motor thrusts) with, where the
configuration names a GP file, the body-frame GP residual of its cluster
0 added to the velocity rows: ``v_dot += R(q) mu(R(q)^T v)``, each output's
posterior mean ``y_mean + sum_j k_inv_y_j sigma_f exp(-0.5 ||(z - X_j) /
l||^2)``. The tick: the circle reference from each vehicle's phase, the
solve (:func:`ocp.solve`), the plant stepped by u0 and its quaternion
renormalized, the phase advanced, the warm start shifted.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from benchmark.reference import ocp


def rotation(q):
    """R(q) of quaternion entries (qw, qx, qy, qz), as a 3x3 list."""
    qw, qx, qy, qz = q
    return [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
    ]


def draw(scen: dict, batch: int, seed: int) -> dict:
    """Per-row circle radius, speed and altitude, float32, each uniform in
    its range of ``scen``, drawn in that order from
    ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(*scen[k], batch).astype(np.float32)
            for k in ("radius", "speed", "alt")}


CHECKOUT = Path(__file__).resolve().parents[2]


def load_gp(path, dtype, device):
    """Cluster 0 of each output of the GP file: (X (D, n, d), a = k_inv_y
    sigma_f (D, n), 1 / l (D, d), y_mean (D,)), with the file's out_idx
    and feat_idx, which must be the body velocities (7, 8, 9). ``path`` is
    relative to the checkout's root."""
    with np.load(CHECKOUT / path) as z:
        if list(z["out_idx"]) != [7, 8, 9] or list(z["feat_idx"]) != [7, 8, 9]:
            raise ValueError(f"{path}: the quad residual takes the body velocities")
        X = z["x_train"][:, 0]
        a = z["k_inv_y"][:, 0] * z["sigma_f"][:, 0, None]
        inv_l = 1.0 / z["len_scale"][:, 0]
        ym = z["y_mean"][:, 0]
    t = lambda v: torch.as_tensor(np.asarray(v, np.float64)).to(device, dtype)
    return t(X), t(a), t(inv_l), t(ym)


def dynamics(model: dict, gp=None):
    """``f(x, u, p)`` of the configuration's ``model`` group (p unused), on
    entries-leading tensors; ``gp`` as :func:`load_gp` gives it."""
    mass, g, T = float(model["mass"]), float(model["g"]), float(model["max_thrust"])
    jx, jy, jz = (float(v) for v in model["inertia"])
    L, ct = float(model["arm_length"]), float(model["c_torque"])
    if model["configuration"] != "x":
        raise ValueError("the reference quad has the 'x' airframe")
    h = math.cos(math.pi / 4) * L
    xf, yf, zl = (h, -h, -h, h), (-h, -h, h, h), (-ct, ct, -ct, ct)

    def f(x, u, p):
        qw, qx, qy, qz = x[3], x[4], x[5], x[6]
        v = (x[7], x[8], x[9])
        wx, wy, wz = x[10], x[11], x[12]
        th = [u[i] * T for i in range(4)]
        acc = (th[0] + th[1] + th[2] + th[3]) / mass
        rows = [
            v[0], v[1], v[2],
            0.5 * (-qx * wx - qy * wy - qz * wz),
            0.5 * (qw * wx + qy * wz - qz * wy),
            0.5 * (qw * wy - qx * wz + qz * wx),
            0.5 * (qw * wz + qx * wy - qy * wx),
            2.0 * (qx * qz + qw * qy) * acc,
            2.0 * (qy * qz - qw * qx) * acc,
            (1.0 - 2.0 * qx * qx - 2.0 * qy * qy) * acc - g,
            (sum(th[i] * yf[i] for i in range(4)) + (jy - jz) * wy * wz) / jx,
            (-sum(th[i] * xf[i] for i in range(4)) + (jz - jx) * wz * wx) / jy,
            (sum(th[i] * zl[i] for i in range(4)) + (jx - jy) * wx * wy) / jz,
        ]
        if gp is not None:
            X, a, inv_l, ym = gp
            R = rotation((qw, qx, qy, qz))
            vb = torch.stack([R[0][k] * v[0] + R[1][k] * v[1] + R[2][k] * v[2]
                              for k in range(3)])  # (3, *S)
            extra = (1,) * (vb.dim() - 1)
            mu = []
            for k in range(3):
                t = (vb[None] - X[k].reshape(*X[k].shape, *extra)) * inv_l[k].reshape(1, 3, *extra)
                e = torch.exp(-0.5 * torch.sum(t * t, dim=1))
                mu.append(ym[k] + torch.sum(a[k].reshape(-1, *extra) * e, dim=0))
            for r in range(3):
                rows[7 + r] = rows[7 + r] + R[r][0] * mu[0] + R[r][1] * mu[1] + R[r][2] * mu[2]
        return torch.stack(rows)

    return f


def circle_window(theta, radius, omega, alt, N, dt):
    """(B, N+1, 13) references along horizontal circles, hover attitude."""
    ar = torch.arange(N + 1, dtype=theta.dtype, device=theta.device)
    th = theta[:, None] + omega[:, None] * ar * dt
    r, om = radius[:, None], omega[:, None]
    z, o = torch.zeros_like(th), torch.ones_like(th)
    return torch.stack([r * torch.cos(th), r * torch.sin(th), alt[:, None].expand_as(th),
                        o, z, z, z, -r * om * torch.sin(th), r * om * torch.cos(th), z,
                        z, z, z], -1)


class Fleet:
    """The reference of one configuration. State of a row: x0 (13), theta,
    radius, speed, alt, warm start xs (N+1, 13), us (N, 4)."""

    def __init__(self, cfg: dict, device, prec: ocp.Precision):
        self.prec = prec
        self.st = ocp.make_stage(cfg["ocp"], device, prec.dtype)
        model = cfg["model"]
        gp = (load_gp(cfg["gp_file"], prec.dtype, device) if cfg.get("gp_file")
              else None)
        self.f = dynamics(model, gp)
        self.hover = float(model["mass"]) * float(model["g"]) / (4 * float(model["max_thrust"]))
        self.device = device

    def init(self, draw: dict) -> dict:
        """The fleet's first state from the traffic's draw: each vehicle on
        its circle at phase 0 with the reference's velocity and hover
        attitude, its warm start that state and the hover input."""
        t = lambda a: torch.as_tensor(a).to(self.device, self.prec.dtype)
        radius, speed, alt = t(draw["radius"]), t(draw["speed"]), t(draw["alt"])
        theta = torch.zeros_like(radius)
        x0 = circle_window(theta, radius, speed / radius, alt, 0, self.st.dt)[:, 0]
        B, N = x0.shape[0], self.st.N
        return {"x0": x0, "theta": theta, "radius": radius, "speed": speed, "alt": alt,
                "xs": x0[:, None].expand(B, N + 1, -1).clone(),
                "us": torch.full((B, N, 4), self.hover, dtype=x0.dtype, device=self.device)}

    def tick(self, s: dict) -> tuple:
        """One tick of every row. Returns (next state, kkt (B,))."""
        st = self.st
        omega = s["speed"] / s["radius"]
        yref = circle_window(s["theta"], s["radius"], omega, s["alt"], st.N, st.dt)
        yref_u = torch.full_like(s["us"], self.hover)
        p = s["x0"].new_zeros((s["x0"].shape[0], 0))
        xs, us, kkt = ocp.solve(self.f, st, s["x0"], yref, yref_u, p, s["xs"], s["us"],
                                self.prec)
        x_next = ocp.step(self.f, st.dt, s["x0"], us[:, 0], p)
        q = x_next[:, 3:7]
        x_next = torch.cat([x_next[:, :3], q / torch.linalg.norm(q, dim=-1, keepdim=True),
                            x_next[:, 7:]], -1)
        xs, us = ocp.shift(xs, us)
        return dict(s, x0=x_next, theta=s["theta"] + omega * st.dt, xs=xs, us=us), kkt
