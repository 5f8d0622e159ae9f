"""Frenet / arc-length reference generator for the AD stack (port of
``ad_mpc_tpu/control/reference.py``).

Waypoint list -> arc-length-parameterized path with filtered curvature;
per tick: closest-point search, Frenet error coordinates, velocity-based
arc-length interpolation of the x/y/psi/curvature references, yaw unwrap
and ``fix_angle_reference``, the stop flag at the path's end, and the
re-anchoring of the first three points to the current pose.

The reference layer runs on the host CPU, as the JAX deployment node pins
it there: its outputs feed the controller's one host-to-device copy per
tick. The arc-length march is a recursion (each step reads the velocity
profile where the last one ended), so it runs as a loop over numpy scalars
of the path's dtype; every other step is a handful of vector operations.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

import numpy as np
import torch

from ad_mpc_tpu_torch.utils.math import (
    fix_angle_reference,
    unwrap_angles,
    wrap_to_pi,
)


class PathData(NamedTuple):
    """Arc-length-parameterized path (the ``set_traj`` product)."""

    x: torch.Tensor
    y: torch.Tensor
    psi: torch.Tensor
    vel: torch.Tensor
    cdist: torch.Tensor  # cumulative arc length s
    curv: torch.Tensor  # filtered curvature dpsi/ds


class WaypointRefs(NamedTuple):
    """Per-tick output (the ``get_waypoints`` dict, as a struct)."""

    s0: torch.Tensor  # arc-length at closest waypoint
    e_y0: torch.Tensor  # lateral Frenet error
    e_psi0: torch.Tensor  # heading Frenet error
    x_ref: torch.Tensor  # (H,)
    y_ref: torch.Tensor
    psi_ref: torch.Tensor
    v_ref: torch.Tensor
    curv_ref: torch.Tensor
    stop: torch.Tensor  # bool: reached end of path


def _moving_average_filtfilt(sig, width: int = 11):
    """Zero-phase moving-average smoothing, the stand-in for the
    reference's ``filtfilt(ones(11)/11, 1, ...)`` curvature filter: an
    edge-padded moving average run backward, then forward."""
    kernel = torch.full((width,), 1.0 / width, dtype=sig.dtype)
    pad = width // 2

    def smooth(s):
        s_pad = torch.cat([s[:1].expand(pad), s, s[-1:].expand(pad)])
        return s_pad.unfold(0, width, 1) @ kernel

    return smooth(smooth(sig.flip(0)).flip(0))


_NP = {torch.float32: np.float32, torch.float64: np.float64}


def interp(x, xp, fp):
    """``jnp.interp`` with its constant extrapolation at both ends: x (H,),
    xp (M,) ascending, fp (..., M) -> (..., H)."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    lo, hi = fp[..., i - 1], fp[..., i]
    eps = float(np.spacing(np.finfo(_NP[xp.dtype]).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, lo, lo + (delta / torch.where(dx0, torch.ones_like(dx), dx))
                    * (hi - lo))
    f = torch.where(x < xp[0], fp[..., :1], f)
    return torch.where(x > xp[-1], fp[..., -1:], f)


def make_path(x, y, psi, vel, filter_width: int = 11,
              dtype=torch.float32) -> PathData:
    """Build the arc-length parameterization (``set_traj`` +
    ``compute_curvature``) as CPU tensors of ``dtype``."""
    x, y, psi, vel = (torch.tensor(np.asarray(a), dtype=dtype)
                      for a in (x, y, psi, vel))
    seg = torch.sqrt(torch.diff(x) ** 2 + torch.diff(y) ** 2)
    cdist = torch.cat([torch.zeros(1, dtype=dtype), torch.cumsum(seg, 0)])
    dpsi = torch.diff(unwrap_angles(psi))
    curv_raw = dpsi / torch.clamp(torch.diff(cdist), min=0.1)
    curv_raw = torch.cat([curv_raw, curv_raw[-1:]])
    curv = _moving_average_filtfilt(curv_raw, filter_width)
    return PathData(x=x, y=y, psi=psi, vel=vel, cdist=cdist, curv=curv)


# Vehicle-level reachable-acceleration envelope, owned here so every
# consumer (enveloped windowing, resample_vel callers, deployment nodes)
# caps against the same physical limits.
ENVELOPE_ACC_MAX = 3.0
ENVELOPE_DEC_MAX = 5.0


def _march(path: PathData, s0, n, dt, v_now, acc_max, dec_max):
    """The arc-length query points: n steps forward from s0, each of dt
    times the path's velocity where the last step ended, capped when
    ``v_now`` is given by the acceleration envelope from v_now. Numpy
    scalars of the path's dtype, the arithmetic of the JAX package's scan
    (``jnp.interp``, ``jnp.clip``) step by step."""
    xp, fp = path.cdist.numpy(), path.vel.numpy()
    f = xp.dtype.type
    keys = xp.tolist()
    last = len(keys) - 1
    eps = np.spacing(np.finfo(xp.dtype).eps)

    def vel_at(s):
        if s < xp[0]:
            return fp[0]
        if s > xp[last]:
            return fp[last]
        i = min(max(bisect.bisect_right(keys, s), 1), last)
        dx = xp[i] - xp[i - 1]
        if abs(dx) <= eps:
            return fp[i - 1]
        return fp[i - 1] + ((s - xp[i - 1]) / dx) * (fp[i] - fp[i - 1])

    h = f(dt)
    s = f(s0)
    out = np.empty(n, xp.dtype)
    if v_now is None:
        for k in range(n):
            s = s + h * vel_at(s)
            out[k] = s
    else:
        v = f(v_now)
        dv_dec, dv_acc, zero = f(dec_max * dt), f(acc_max * dt), f(0.0)
        for k in range(n):
            v = min(max(vel_at(s), max(v - dv_dec, zero)), v + dv_acc)
            s = s + h * v
            out[k] = s
    return torch.from_numpy(out)


def get_waypoints(
    path: PathData, x_init, y_init, psi_init, traj_horizon: int,
    traj_dt: float, v_now=None, acc_max: float = ENVELOPE_ACC_MAX,
    dec_max: float = ENVELOPE_DEC_MAX,
) -> WaypointRefs:
    """Per-tick local reference extraction (``get_waypoints``).

    ``v_now`` (optional): current vehicle speed. When given, the
    arc-length march is capped by the reachable acceleration envelope from
    ``v_now``, so positions AND velocities describe the same reachable
    window (capping only the velocity row leaves the positions marching at
    the path's speed, which is untrackable from low speed)."""
    dt_ = path.x.dtype
    as_t = lambda v: torch.as_tensor(v, dtype=dt_)
    x_init, y_init = as_t(x_init), as_t(y_init)
    psi_init = wrap_to_pi(as_t(psi_init))

    # (1) Closest waypoint.
    ci = torch.argmin((path.x - x_init) ** 2 + (path.y - y_init) ** 2)

    # (2) Frenet error coordinates.
    psi_w = path.psi[ci]
    cos_p, sin_p = torch.cos(psi_w), torch.sin(psi_w)
    ex = x_init - path.x[ci]
    ey = y_init - path.y[ci]
    e_y0 = -sin_p * ex + cos_p * ey
    s0 = path.cdist[ci]
    e_psi0 = wrap_to_pi(psi_init - psi_w)

    # (3) Velocity-based arc-length march anchored at s0, then every row
    # interpolated at the query points at once.
    s_query = _march(path, s0.item(), traj_horizon, traj_dt,
                     None if v_now is None else float(v_now), acc_max, dec_max)
    rows = torch.stack([path.x, path.y, unwrap_angles(path.psi), path.cdist,
                        path.curv])
    x_ref, y_ref, psi_ref, cdist_ref, curv_ref = interp(s_query, path.cdist, rows)

    psi_ref = wrap_to_pi(fix_angle_reference(psi_ref, psi_init))

    # v_ref by finite differences of the interpolated arc length.
    v_ref = torch.diff(cdist_ref) / traj_dt
    v_ref = torch.cat([v_ref, v_ref[-1:]])

    stop = cdist_ref[-1] >= path.cdist[-1] - 1e-9

    # First-3-point re-anchoring to the current pose: keeps the front of
    # the reference reachable from where the car is. The arrays stay length
    # H (last point dropped).
    def reanchor(ref, first3):
        return torch.cat([first3, ref[2:-1]])

    def line3(start, stop_):  # jnp.linspace(start, stop, 3)
        return torch.stack([start, start * 0.5 + stop_ * 0.5, stop_])

    x_ref = reanchor(x_ref, line3(x_init, x_ref[1]))
    y_ref = reanchor(y_ref, line3(y_init, y_ref[1]))
    psi_ref = reanchor(psi_ref, psi_ref[0].expand(3))
    v_ref = reanchor(v_ref, v_ref[2].expand(3))
    curv_ref = reanchor(curv_ref, curv_ref[0].expand(3))

    return WaypointRefs(
        s0=s0, e_y0=e_y0, e_psi0=e_psi0,
        x_ref=x_ref, y_ref=y_ref, psi_ref=psi_ref, v_ref=v_ref,
        curv_ref=curv_ref, stop=stop,
    )


def resample_vel(v_ref, v_now, dt, acc_max: float = ENVELOPE_ACC_MAX,
                 dec_max: float = ENVELOPE_DEC_MAX):
    """Limit the velocity reference to the reachable acceleration envelope
    from the current speed (node-level ``resample_vel``)."""
    steps = torch.arange(1, v_ref.shape[0] + 1, dtype=v_ref.dtype)
    upper = v_now + acc_max * dt * steps
    lower = torch.clamp(v_now - dec_max * dt * steps, min=0.0)
    return torch.minimum(torch.maximum(v_ref, lower), upper)


class PathReference:
    """Stateful wrapper with the reference's ``RefTrajectory`` API
    (``set_traj`` / ``get_waypoints``) over the functions above; the path
    is kept as CPU tensors of ``dtype``."""

    def __init__(self, traj_horizon: int = 10, traj_dt: float = 0.2,
                 dtype=torch.float32):
        self.traj_horizon = traj_horizon
        self.traj_dt = traj_dt
        self.dtype = dtype
        self._path: PathData | None = None

    def set_traj(self, x_ref, y_ref, psi_ref, vel_ref):
        self._path = make_path(x_ref, y_ref, psi_ref, vel_ref, dtype=self.dtype)

    def _require_path(self) -> PathData:
        if self._path is None:
            raise RuntimeError("trajectory has not been set")
        return self._path

    def get_waypoints(self, x_init, y_init, psi_init) -> WaypointRefs:
        return get_waypoints(self._require_path(), x_init, y_init, psi_init,
                             self.traj_horizon, self.traj_dt)

    def get_waypoints_enveloped(
        self, x_init, y_init, psi_init, v_now,
        acc_max: float = ENVELOPE_ACC_MAX, dec_max: float = ENVELOPE_DEC_MAX,
    ) -> WaypointRefs:
        """Reference window capped by the reachable acceleration envelope
        from the current speed: positions and velocities consistent (see
        :func:`get_waypoints`)."""
        return get_waypoints(self._require_path(), x_init, y_init, psi_init,
                             self.traj_horizon, self.traj_dt, v_now=v_now,
                             acc_max=acc_max, dec_max=dec_max)
