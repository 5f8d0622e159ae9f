"""Multi-segment minimum-snap polynomial waypoint interpolation.

A copy of the JAX package's numpy module of the same name (the port
imports nothing of that package).

Capability parity with the reference's polynomial trajectory generator
(``ros_gp_mpc/src/utils/trajectory_generator.py``:
``fit_multi_segment_polynomial_trajectory`` + ``get_full_traj``): fit one
7th-order polynomial per waypoint segment, per axis, minimizing the snap
integral subject to waypoint interpolation, C^3 continuity at interior
knots, and rest (zero vel/acc/jerk) endpoints; then sample position through
jerk on a uniform grid for the differential-flatness map.

Host-side precompute in numpy (the same role the reference gives it); the
sampled derivative stack feeds
:func:`ad_mpc_tpu_torch.trajectories.quad_refs.minimum_snap_trajectory`.
"""

from __future__ import annotations

import numpy as np

_ORDER = 7  # polynomial order per segment (8 coefficients)
_NC = _ORDER + 1


def _dcoef(der: int):
    """Coefficient multipliers and exponent shift for the der-th derivative
    of t^k, k=0..7: d^der/dt^der t^k = (k!/(k-der)!) t^(k-der)."""
    k = np.arange(_NC)
    mult = np.ones(_NC)
    for d in range(der):
        mult *= np.maximum(k - d, 0)
    return mult


def _row(t: float, der: int):
    """Row vector r with r @ coeffs = der-th derivative of the poly at t."""
    k = np.arange(_NC)
    mult = _dcoef(der)
    expo = np.maximum(k - der, 0)
    return mult * np.power(t, expo) * (k >= der)


def _snap_gram(T: float):
    """Gram matrix H with c^T H c = integral_0^T (p'''')^2 dt."""
    H = np.zeros((_NC, _NC))
    m4 = _dcoef(4)
    for i in range(4, _NC):
        for j in range(4, _NC):
            p = (i - 4) + (j - 4)
            H[i, j] = m4[i] * m4[j] * T ** (p + 1) / (p + 1)
    return H


def fit_multi_segment_polynomial(t_knots, waypoints):
    """Fit per-axis multi-segment min-snap polynomials.

    :param t_knots: (M+1,) strictly increasing knot times.
    :param waypoints: (M+1, d) waypoint positions.
    :return: coeffs (M, d, 8) — per-segment, per-axis polynomial
        coefficients in the segment-local time ``tau = t - t_knots[i]``.
    """
    t_knots = np.asarray(t_knots, dtype=float)
    waypoints = np.atleast_2d(np.asarray(waypoints, dtype=float))
    M = len(t_knots) - 1
    d = waypoints.shape[1]
    n = M * _NC

    # Snap cost over all segments (block diagonal), slightly regularized so
    # the KKT system is nonsingular (snap ignores the cubic subspace).
    H = np.zeros((n, n))
    for i in range(M):
        T = t_knots[i + 1] - t_knots[i]
        H[i * _NC : (i + 1) * _NC, i * _NC : (i + 1) * _NC] = _snap_gram(T)
    H += 1e-9 * np.eye(n)

    rows, rhs_idx = [], []

    def add(seg, t_local, der, value_row):
        r = np.zeros(n)
        r[seg * _NC : (seg + 1) * _NC] = _row(t_local, der)
        rows.append(r)
        rhs_idx.append(value_row)

    # Waypoint interpolation at both ends of every segment.
    for i in range(M):
        T = t_knots[i + 1] - t_knots[i]
        add(i, 0.0, 0, ("wp", i))
        add(i, T, 0, ("wp", i + 1))
    # C^1..C^3 continuity at interior knots.
    for i in range(M - 1):
        T = t_knots[i + 1] - t_knots[i]
        for der in (1, 2, 3):
            r = np.zeros(n)
            r[i * _NC : (i + 1) * _NC] = _row(T, der)
            r[(i + 1) * _NC : (i + 2) * _NC] -= _row(0.0, der)
            rows.append(r)
            rhs_idx.append(("zero",))
    # Rest endpoints: zero vel/acc/jerk.
    for der in (1, 2, 3):
        add(0, 0.0, der, ("zero",))
        add(M - 1, t_knots[-1] - t_knots[-2], der, ("zero",))

    A = np.stack(rows)
    m = A.shape[0]

    # KKT solve per axis: [H A^T; A 0] [c; lam] = [0; b].
    K = np.block([[H, A.T], [A, np.zeros((m, m))]])
    coeffs = np.zeros((M, d, _NC))
    for ax in range(d):
        b = np.zeros(m)
        for j, tag in enumerate(rhs_idx):
            if tag[0] == "wp":
                b[j] = waypoints[tag[1], ax]
        sol = np.linalg.solve(K, np.concatenate([np.zeros(n), b]))
        coeffs[:, ax, :] = sol[:n].reshape(M, _NC)
    return coeffs


def sample_polynomial_trajectory(coeffs, t_knots, dt: float):
    """Sample pos/vel/acc/jerk of a fitted multi-segment polynomial.

    :return: (derivatives (4, d, n), t (n,)) — the input format of
        ``minimum_snap_trajectory`` (``trajectory_generator.py:get_full_traj``).
    """
    t_knots = np.asarray(t_knots, dtype=float)
    M, d, _ = coeffs.shape
    t = np.arange(0.0, t_knots[-1], dt)
    seg = np.clip(np.searchsorted(t_knots, t, side="right") - 1, 0, M - 1)
    tau = t - t_knots[seg]

    out = np.zeros((4, d, len(t)))
    k = np.arange(_NC)
    for der in range(4):
        mult = _dcoef(der)
        expo = np.maximum(k - der, 0)
        basis = mult[None, :] * np.power(tau[:, None], expo[None, :]) * (
            k[None, :] >= der
        )  # (n, 8)
        for ax in range(d):
            c = coeffs[seg, ax, :]  # (n, 8)
            out[der, ax] = np.sum(basis * c, axis=1)
    return out, t
