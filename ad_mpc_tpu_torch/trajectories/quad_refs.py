"""Quadrotor reference-trajectory library via differential flatness.

A numpy copy of ``ad_mpc_tpu/trajectories/quad_refs.py`` (the port imports
nothing of the JAX package). The yawing branch's rotation-to-quaternion
step, which the JAX package runs through ``jnp``, is numpy here
(:func:`_rotation_matrix_to_quat`), with the norm summed as XLA's CPU
reduction sums it, so that both packages give the same reference bits.

Capability parity with the reference's trajectory library
(``ros_gp_mpc/src/utils/trajectories.py``): loop and lemniscate speed-ramp
profiles, the minimum-snap flatness map (position derivatives -> attitude
quaternions, body rates, per-motor inputs via the mixer matrix,
``trajectories.py:128-282``), and the dynamic-feasibility validator
``check_trajectory`` (``trajectories.py:30-126``).

All generators are fully vectorized (no per-sample Python loops) and run as
host-side precompute; outputs are plain numpy arrays fed to the on-device
MPC loop.
"""

from __future__ import annotations

import numpy as np

from ad_mpc_tpu_torch.models.quadrotor import QuadrotorParams


# ---------------------------------------------------------------- quaternion
# numpy quaternion helpers (host-side; [w,x,y,z])

def _q_mul(q, r):
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rw, rx, ry, rz = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return np.stack(
        [
            qw * rw - qx * rx - qy * ry - qz * rz,
            qw * rx + qx * rw + qy * rz - qz * ry,
            qw * ry - qx * rz + qy * rw + qz * rx,
            qw * rz + qx * ry - qy * rx + qz * rw,
        ],
        axis=-1,
    )


def _q_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _q_normalize(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _two_sum(a, b):
    """(a + b rounded, its rounding error), exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """(a b rounded, its rounding error), exactly (Dekker's product with
    Veltkamp's split)."""
    p = a * b
    split = lambda x: (lambda c: (c - (c - x), x - (c - (c - x))))(134217729.0 * x)
    (ah, al), (bh, bl) = split(a), split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma(a, b, c):
    """a b + c rounded once (a fused multiply-add), elementwise in float64:
    the exact product and sum, the low part rounded to odd, then the sum
    rounded to nearest (Boldo and Melquiond, IEEE TC 57(4), 2008)."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, w = _two_sum(tl, ul)
    even = (v.view(np.int64) & 1) == 0
    v = np.where((w != 0) & even, np.nextafter(v, np.where(w > 0, np.inf, -np.inf)), v)
    return th + v


def _rotation_matrix_to_quat(rot):
    """Rotation matrices (n, 3, 3) -> unit quaternions (n, 4) by the
    branch-free Shepperd extraction of ``utils.math.rotation_matrix_to_quat``
    in numpy, the norm's squares summed left to right by fused
    multiply-adds, as XLA's CPU reduction sums them for ``jnp.linalg.norm``."""
    m = lambda i, j: rot[:, i, j]
    tr = m(0, 0) + m(1, 1) + m(2, 2)
    qw2 = np.maximum(1 + tr, 0.0)
    qx2 = np.maximum(1 + m(0, 0) - m(1, 1) - m(2, 2), 0.0)
    qy2 = np.maximum(1 - m(0, 0) + m(1, 1) - m(2, 2), 0.0)
    qz2 = np.maximum(1 - m(0, 0) - m(1, 1) + m(2, 2), 0.0)
    cand = lambda comps, s: np.stack(comps, axis=-1) / (
        2 * np.sqrt(s + 1e-12)[:, None])
    cands = np.stack([
        cand([qw2, m(2, 1) - m(1, 2), m(0, 2) - m(2, 0), m(1, 0) - m(0, 1)], qw2),
        cand([m(2, 1) - m(1, 2), qx2, m(0, 1) + m(1, 0), m(0, 2) + m(2, 0)], qx2),
        cand([m(0, 2) - m(2, 0), m(0, 1) + m(1, 0), qy2, m(1, 2) + m(2, 1)], qy2),
        cand([m(1, 0) - m(0, 1), m(0, 2) + m(2, 0), m(1, 2) + m(2, 1), qz2], qz2),
    ], axis=1)
    best = np.argmax(np.stack([qw2, qx2, qy2, qz2], axis=-1), axis=-1)
    q = cands[np.arange(len(best)), best]
    acc = q[:, 0] * q[:, 0]
    for i in range(1, 4):
        acc = _fma(q[:, i], q[:, i], acc)
    return q / np.sqrt(acc)[:, None]


def _rates_from_quat(q, dt):
    """Body rates from numerical quaternion differentiation:
    w = 2 * (q^-1 * q_dot)_vec."""
    q_dot = np.gradient(q, axis=0) / dt
    return 2.0 * _q_mul(_q_conj(q), q_dot)[:, 1:]


# ------------------------------------------------------------------ flatness

def minimum_snap_trajectory(
    traj_derivatives,
    yaw_derivatives,
    t_ref,
    quad: QuadrotorParams = QuadrotorParams(),
):
    """Differential-flatness map from position derivatives to the full
    13-state + 4-input reference (``trajectories.py:128-282``).

    :param traj_derivatives: (4, 3, n) pos/vel/acc/jerk x/y/z rows (3
        derivative rows accepted when not yawing — jerk then unused).
    :param yaw_derivatives: (2, n) yaw and yaw-rate rows.
    :return: (traj (n,13), t_ref (n,), inputs (n,4) normalized to [0,1]).
    """
    dt = t_ref[1] - t_ref[0]
    n = traj_derivatives.shape[2]
    g = 9.81

    acc = traj_derivatives[2].T  # (n, 3)
    thrust = acc + np.array([0.0, 0.0, g])
    z_b = thrust / np.linalg.norm(thrust, axis=1, keepdims=True)
    f_t = quad.mass * np.sum(z_b * thrust, axis=1, keepdims=True)

    yawing = np.any(yaw_derivatives[0] != 0)

    if yawing:
        yaw = yaw_derivatives[0]
        x_c = np.stack([np.cos(yaw), np.sin(yaw), np.zeros(n)], axis=1)
        y_b = np.cross(z_b, x_c)
        y_b /= np.linalg.norm(y_b, axis=1, keepdims=True)
        x_b = np.cross(y_b, z_b)
        rot = np.stack([x_b, y_b, z_b], axis=-1)  # body->world

        q = _rotation_matrix_to_quat(rot)
        # Vectorized sign-continuity (undo_quaternion_flip over the sequence).
        dots = np.sum(q[1:] * q[:-1], axis=1)
        flips = np.concatenate([[1.0], np.cumprod(np.sign(dots + 1e-30))])
        q = q * flips[:, None]

        # Body rates by numeric quaternion differentiation — exactly the
        # quantity the feasibility validator and the OCP reference need.
        # (The reference's analytic h_omega mapping here disagrees with its
        # own check_trajectory validator; numeric rates are consistent by
        # construction.)
        rate = _rates_from_quat(q, dt)
    else:
        # Tilt-only attitude: shortest rotation taking e_z to z_b
        # (trajectories.py:199-205).
        e_z = np.array([0.0, 0.0, 1.0])
        q_w = 1.0 + z_b @ e_z
        q_xyz = np.cross(e_z[None, :], z_b)
        q = _q_normalize(np.concatenate([q_w[:, None], q_xyz], axis=1))

        rate = _rates_from_quat(q, dt)
        # Yaw-rate cancellation ("go_crazy_about_yaw",
        # trajectories.py:216-236): rotate each sample about body-z by the
        # accumulated negative yaw so the reference carries ~zero yaw rate.
        yaw_corr_acc = np.concatenate([[0.0], np.cumsum(-rate[1:, 2] * dt)])
        q_corr = np.stack(
            [
                np.cos(yaw_corr_acc / 2),
                np.zeros(n),
                np.zeros(n),
                np.sin(yaw_corr_acc / 2),
            ],
            axis=1,
        )
        q = _q_mul(q, q_corr)
        rate = _rates_from_quat(q, dt)

    # Inputs from the mixer matrix (trajectories.py:238-252).
    j = np.asarray(quad.j)
    rate_dot = np.gradient(rate, axis=0) / dt
    coriolis = np.stack(
        [
            (j[2] - j[1]) * rate[:, 2] * rate[:, 1],
            (j[0] - j[2]) * rate[:, 0] * rate[:, 2],
            (j[1] - j[0]) * rate[:, 1] * rate[:, 0],
        ],
        axis=1,
    )
    tau = rate_dot * j[None, :] + coriolis
    b = np.concatenate([tau, f_t], axis=1)
    a_mat = np.stack(
        [quad.y_f, -quad.x_f, quad.z_l_tau, np.ones(4)], axis=0
    )
    inputs = np.linalg.solve(a_mat[None, :, :], b[:, :, None])[:, :, 0]

    pos = traj_derivatives[0].T
    vel = traj_derivatives[1].T
    traj = np.concatenate([pos, q, vel, rate], axis=1)
    # Start at the origin in XY (map handling of trajectories.py:258-261).
    traj[:, 0] -= traj[0, 0]
    traj[:, 1] -= traj[0, 1]

    return traj, t_ref, inputs / quad.max_thrust


# --------------------------------------------------------- speed-ramp phases

def _alpha_profile(discretization_dt, lin_acc, radius, v_max, ramp_up_t=2.0):
    """Angular-acceleration profile shared by loop/lemniscate: sin^2 ramp-up,
    constant acceleration coast, cosine transition to deceleration, coast
    down, ramp to rest (``trajectories.py:386-423``)."""
    dt = discretization_dt
    t_total = 2 * v_max / lin_acc + 2 * ramp_up_t
    alpha_acc = lin_acc / radius

    ramp_t = np.arange(0, ramp_up_t, dt)
    ramp_alpha = alpha_acc * np.sin(np.pi / (2 * ramp_up_t) * ramp_t) ** 2
    ramp_alpha_dt = (
        alpha_acc * np.pi / (2 * ramp_up_t) * np.sin(np.pi / ramp_up_t * ramp_t)
    )

    coasting_duration = (t_total - 4 * ramp_up_t) / 2
    coast_t = ramp_up_t + np.arange(0, coasting_duration, dt)
    coast_alpha = np.full_like(coast_t, alpha_acc)

    trans_t = np.arange(0, 2 * ramp_up_t, dt)
    trans_alpha = alpha_acc * np.cos(np.pi / (2 * ramp_up_t) * trans_t)
    trans_alpha_dt = (
        -alpha_acc * np.pi / (2 * ramp_up_t)
        * np.sin(np.pi / (2 * ramp_up_t) * trans_t)
    )
    trans_t = trans_t + coast_t[-1] + dt

    down_t = trans_t[-1] + np.arange(0, coasting_duration, dt) + dt
    down_alpha = -np.full_like(down_t, alpha_acc)

    end_t = down_t[-1] + np.arange(0, ramp_up_t, dt) + dt
    end_alpha = ramp_alpha - alpha_acc

    t_ref = np.concatenate([ramp_t, coast_t, trans_t, down_t, end_t])
    alpha = np.concatenate(
        [ramp_alpha, coast_alpha, trans_alpha, down_alpha, end_alpha]
    )
    alpha_dt = np.concatenate(
        [ramp_alpha_dt, np.zeros_like(coast_alpha), trans_alpha_dt,
         np.zeros_like(down_alpha), ramp_alpha_dt]
    )

    w = np.cumsum(alpha) * dt
    angle = np.cumsum(w) * dt
    return t_ref, alpha, alpha_dt, w, angle


def loop_trajectory(
    quad: QuadrotorParams = QuadrotorParams(),
    discretization_dt: float = 0.01,
    radius: float = 5.0,
    z: float = 1.0,
    lin_acc: float = 0.5,
    clockwise: bool = True,
    yawing: bool = False,
    v_max: float = 8.0,
):
    """Circular trajectory with ramped speed (``trajectories.py:357-464``)."""
    t_ref, alpha, alpha_dt, w, angle = _alpha_profile(
        discretization_dt, lin_acc, radius, v_max
    )
    if not clockwise:
        alpha, alpha_dt = -alpha, -alpha_dt
        w = np.cumsum(alpha) * discretization_dt
        angle = np.cumsum(w) * discretization_dt

    sin_a, cos_a = np.sin(angle), np.cos(angle)
    pos = np.stack([radius * sin_a, radius * cos_a, np.full_like(angle, z)])
    vel = np.stack(
        [radius * w * cos_a, -radius * w * sin_a, np.zeros_like(angle)]
    )
    acc = np.stack(
        [
            radius * (alpha * cos_a - w**2 * sin_a),
            -radius * (alpha * sin_a + w**2 * cos_a),
            np.zeros_like(angle),
        ]
    )
    jerk = np.stack(
        [
            radius * (alpha_dt * cos_a - alpha * sin_a * w
                      - cos_a * w**3 - 2 * sin_a * w * alpha),
            -radius * (cos_a * w * alpha + sin_a * alpha_dt
                       - sin_a * w**3 + 2 * cos_a * w * alpha),
            np.zeros_like(angle),
        ]
    )
    traj = np.stack([pos, vel, acc, jerk])
    yaw = (
        np.stack([-angle, -w])
        if yawing
        else np.zeros((2, len(angle)))
    )
    return minimum_snap_trajectory(traj, yaw, t_ref, quad)


def lemniscate_trajectory(
    quad: QuadrotorParams = QuadrotorParams(),
    discretization_dt: float = 0.01,
    radius: float = 5.0,
    z: float = 1.0,
    lin_acc: float = 0.25,
    v_max: float = 8.0,
):
    """Figure-8 (x = r cos, y = r sin*cos) with ramped speed
    (``trajectories.py:467-561``)."""
    t_ref, alpha, alpha_dt, w, angle = _alpha_profile(
        discretization_dt, lin_acc, radius, v_max
    )
    sin_a, cos_a = np.sin(angle), np.cos(angle)
    pos = np.stack(
        [radius * cos_a, radius * sin_a * cos_a, np.full_like(angle, z)]
    )
    vel = np.stack(
        [
            -radius * w * sin_a,
            radius * (w * cos_a**2 - w * sin_a**2),
            np.zeros_like(angle),
        ]
    )
    acc = np.stack(
        [
            -radius * (alpha * sin_a + w**2 * cos_a),
            radius * (alpha * cos_a**2 - alpha * sin_a**2
                      - 4.0 * w**2 * cos_a * sin_a),
            np.zeros_like(angle),
        ]
    )
    traj = np.stack([pos, vel, acc])
    yaw = np.zeros((2, len(angle)))
    return minimum_snap_trajectory(traj, yaw, t_ref, quad)


def straight_trajectory(
    quad: QuadrotorParams = QuadrotorParams(),
    discretization_dt: float = 0.01,
    start=np.array([0.0, 0.0, 1.0]),
    end=np.array([10.0, 0.0, 1.0]),
    speed: float = 2.0,
):
    """Straight line with sin^2 speed ramp-up/coast/ramp-down
    (``trajectories.py:307-321``)."""
    start = np.asarray(start, dtype=float)
    end = np.asarray(end, dtype=float)
    length = float(np.linalg.norm(end - start))
    direction = (end - start) / max(length, 1e-9)

    # sin^2 ramps cover speed*ramp_t/2 distance each end; clamp ramp time so
    # the two ramps never exceed the total length (short hops).
    ramp_t = min(speed / 1.0, length / speed)  # ramp at ~1 m/s^2
    dt = discretization_dt
    coast_len = max(length - speed * ramp_t, 0.0)
    coast_t = coast_len / speed

    t_up = np.arange(0.0, ramp_t, dt)
    v_up = speed * np.sin(np.pi * t_up / (2 * ramp_t)) ** 2
    t_c = np.arange(0.0, coast_t, dt)
    v_c = np.full_like(t_c, speed)
    t_dn = np.arange(0.0, ramp_t, dt)
    v_dn = speed * np.cos(np.pi * t_dn / (2 * ramp_t)) ** 2

    v = np.concatenate([v_up, v_c, v_dn])
    t_ref = np.arange(len(v)) * dt
    s = np.cumsum(v) * dt
    a = np.gradient(v) / dt

    pos = start[None, :] + s[:, None] * direction[None, :]
    vel = v[:, None] * direction[None, :]
    acc = a[:, None] * direction[None, :]
    traj = np.stack([pos.T, vel.T, acc.T])
    yaw = np.zeros((2, len(v)))
    return minimum_snap_trajectory(traj, yaw, t_ref, quad)


def random_trajectory(
    quad: QuadrotorParams = QuadrotorParams(),
    discretization_dt: float = 0.01,
    seed: int = 0,
    duration: float = None,
    speed: float = 1.5,
    n_keyframes: int = 8,
    map_limits=((-5.0, 5.0), (-5.0, 5.0), (0.5, 3.0)),
):
    """Random smooth aggressive trajectory (``trajectories.py:324-354``):
    periodic random keyframes -> multi-segment min-snap polynomial ->
    differential-flatness reference.

    Time allocation mirrors the reference's ``av_dt = av_dist / speed``
    (``trajectories.py:341-343``): segment durations are segment length over
    the target ``speed``, so higher speed means a faster (shorter) flight
    over the same keyframe path. ``duration`` (if given) overrides speed by
    scaling the total flight time instead.
    """
    from ad_mpc_tpu_torch.trajectories.keyframes import random_periodical_keyframes
    from ad_mpc_tpu_torch.trajectories.polynomial import (
        fit_multi_segment_polynomial,
        sample_polynomial_trajectory,
    )

    kf, _ = random_periodical_keyframes(
        n_keyframes=n_keyframes, map_limits=map_limits, seed=seed
    )
    # Time allocation proportional to segment length, scaled by target speed.
    seg_len = np.linalg.norm(np.diff(kf, axis=0), axis=1)
    t_knots = np.concatenate([[0.0], np.cumsum(seg_len)])
    if duration is None:
        duration = max(float(t_knots[-1]) / max(speed, 1e-6), 2.0)
    t_knots = t_knots / max(t_knots[-1], 1e-9) * duration

    coeffs = fit_multi_segment_polynomial(t_knots, kf)
    derivs, t_ref = sample_polynomial_trajectory(
        coeffs, t_knots, discretization_dt
    )
    yaw = np.zeros((2, len(t_ref)))
    return minimum_snap_trajectory(derivs, yaw, t_ref, quad)


# ----------------------------------------------------------------- validator

def check_trajectory(trajectory, inputs, tvec, atol=(1e-2, 1e-3, 0.05)):
    """Dynamic-feasibility validator (``trajectories.py:30-126``), vectorized:

    1. numeric d(pos)/dt must match the analytic velocity;
    2. attitude must be consistent with the acceleration direction (up to
       yaw);
    3. body rates must agree with numeric quaternion differentiation;
    4. quaternions must have unit norm.

    Returns (ok: bool, errors: dict of max errors).
    """
    trajectory = np.asarray(trajectory)
    dt = np.gradient(np.asarray(tvec))[:, None]
    numeric = np.gradient(trajectory, axis=0) / dt

    errors = {}
    v_err = np.linalg.norm(numeric[:, 0:3] - trajectory[:, 7:10], axis=1)
    errors["velocity"] = float(np.max(v_err))
    ok = np.allclose(numeric[:, 0:3], trajectory[:, 7:10],
                     atol=atol[0], rtol=atol[0])

    q = trajectory[:, 3:7]
    qn_err = np.abs(np.linalg.norm(q, axis=1) - 1.0)
    errors["quat_norm"] = float(np.max(qn_err))
    ok &= bool(np.max(qn_err) < 1e-6)

    thrust = numeric[:, 7:10] + np.array([0.0, 0.0, 9.81])
    thrust /= np.linalg.norm(thrust, axis=1, keepdims=True)
    e_z = np.array([0.0, 0.0, 1.0])
    q_num = np.concatenate(
        [(1.0 + thrust @ e_z)[:, None], np.cross(e_z[None, :], thrust)], axis=1
    )
    q_num = _q_normalize(0.5 * q_num)
    q_diff = _q_mul(_q_conj(q), q_num)
    att_err = np.linalg.norm(q_diff[:, 1:3], axis=1)
    errors["attitude"] = float(np.max(att_err))
    ok &= np.allclose(q_diff[:, 1:3], 0.0, atol=atol[1], rtol=atol[1])

    w_num = 2.0 * _q_mul(_q_conj(q), numeric[:, 3:7])[:, 1:]
    w_err = np.linalg.norm(w_num - trajectory[:, 10:13], axis=1)
    errors["body_rate"] = float(np.max(w_err))
    ok &= np.allclose(w_num, trajectory[:, 10:13], atol=atol[2], rtol=atol[2])

    return bool(ok), errors
