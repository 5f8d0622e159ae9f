"""Quadrotor mission node (port of ``ad_mpc_tpu/nodes/quad_node.py``; the
``gp_mpc_node.py`` role).

- the mission state machine of ``set_reference`` (``gp_mpc_node.py:518-692``):
  provisional hover -> ascend to the trajectory start -> track -> land ->
  off;
- optimization on every second odometry message, with skipped-message
  compensation by sequence number (``odometry_callback:443-492``);
- the dense reference windowed and downsampled onto the MPC horizon
  (``gp_mpc_node.py:652-661``);
- recording rows (state_in, u, dt, t) for GP fitting, with each row's
  nominal prediction (``save_recording_data``, ``gp_mpc_node.py:710-754``),
  and the tracking RMSE (``gp_mpc_node.py:556-599``).

The node is a synchronous stepper: ``step(x, t)`` takes one state estimate
and returns the control to apply, so that the loop is deterministic and the
transport (``nodes/quad_controller.py``) wraps it unchanged. The MPC's solve
runs on its device (the card by default); per optimized message the node
fetches u0 and the predicted states to the host in one copy, and QuadMPC's
watchdog fetches one scalar. The held u0 of a skipped message stays on the
host. The recording's nominal prediction (40 RK4 sub-steps a row) runs on
the host in float64, for all rows at once when the recording is read, so
that the 160 model evaluations of a row do not lengthen the message that
records it.
"""

from __future__ import annotations

import time
from enum import Enum
from typing import Optional

import numpy as np
import torch

from ad_mpc_tpu_torch.control.mpc import QuadMPC, quad_spec
from ad_mpc_tpu_torch.models.quadrotor import QuadDynamics, hover_input
from ad_mpc_tpu_torch.ops.integrators import discrete_step


class MissionPhase(Enum):
    HOVER = "hover"  # provisional hover at the current position
    ASCEND = "ascend"  # rise to the trajectory's start point
    TRACK = "track"  # follow the loaded reference
    LAND = "land"  # descend to the ground
    OFF = "off"


def fetch_solution(us, xs):
    """(u0 (nu,), xs (N+1, nx)) as host arrays: for tensors, one copy of
    both to the host."""
    if not isinstance(us, torch.Tensor):
        return np.asarray(us[0]), np.asarray(xs)
    nu = us.shape[-1]
    flat = torch.cat([us[0], xs.reshape(-1)]).cpu().numpy()
    return flat[:nu], flat[nu:].reshape(tuple(xs.shape))


class QuadMissionNode:
    """Synchronous mission controller over one :class:`QuadMPC` (by default
    ``quad_spec(n_nodes=, t_horizon=)`` on ``device``)."""

    def __init__(self, mpc: Optional[QuadMPC] = None, n_nodes: int = 10,
                 t_horizon: float = 1.0, control_period: float = 0.02,
                 optimize_every: int = 2, land_z: float = 0.1,
                 record: bool = False, device="cuda"):
        self.mpc = mpc if mpc is not None else QuadMPC(
            spec=quad_spec(n_nodes=n_nodes, t_horizon=t_horizon), device=device)
        self.spec = self.mpc.spec
        self.control_period = control_period
        self.optimize_every = optimize_every
        self.land_z = land_z
        self.phase = MissionPhase.HOVER
        self.record = record

        # The loaded dense reference, set by receive_trajectory.
        self._traj = None
        self._t_ref = None
        self._u_traj = None
        self._track_t0 = None

        self._msg_count = 0
        self._last_u = np.asarray(hover_input())
        self._hover_point = None
        # Sequence-number gating (skipped-message compensation).
        self._last_seq = None
        self._optimize_next = True
        self.n_skipped = 0
        self.n_optimized = 0
        # Host-clock seconds of each optimized message's solve: the
        # reference's and state's copies to the device, the solve and the
        # fetch of its result.
        self.solve_s: list[float] = []
        self.last_xs = None  # the latest predicted trajectory (body rates)

        self.records: list[dict] = []
        self._track_err2 = []
        self._nominal = QuadDynamics(self.mpc.params)
        self._nominal_steps = int(max(round(control_period / 5e-4), 1))

    # ------------------------------------------------------------- reference

    def receive_trajectory(self, traj, t_ref, u_traj=None):
        """Load a dense reference (the ``ReferenceTrajectory`` message) and
        arm the ASCEND phase."""
        self._traj = np.array(traj)  # a copy: a decoded message is read-only
        self._t_ref = np.array(t_ref)
        self._u_traj = (np.array(u_traj) if u_traj is not None
                        else np.tile(hover_input(), (len(t_ref), 1)))
        self._track_t0 = None
        self.phase = MissionPhase.ASCEND

    def _reference_window(self, t_now: float):
        """The dense reference from time ``t_now``, downsampled onto the
        horizon's N+1 nodes."""
        n = self.spec.n_nodes
        i0 = int(np.searchsorted(self._t_ref, t_now))
        ref_dt = self._t_ref[1] - self._t_ref[0]
        stride = max(int(round(self.spec.dt / ref_dt)), 1)
        idx = np.clip(i0 + stride * np.arange(n + 1), 0, len(self._t_ref) - 1)
        u_idx = np.clip(idx[:-1], 0, len(self._u_traj) - 1)
        return self._traj[idx], self._u_traj[u_idx]

    def _point_reference(self, p):
        n = self.spec.n_nodes
        ref = np.zeros((n + 1, 13))
        ref[:, :3] = p
        ref[:, 3] = 1.0  # identity quaternion
        return ref, np.tile(hover_input(), (n, 1))

    # ---------------------------------------------------------- mission step

    def step(self, x: np.ndarray, t: float, seq: int | None = None):
        """One odometry message: advance the state machine, maybe optimize.
        Returns the control (4,) to apply (the previous one on a skipped
        message).

        ``seq``: the message's sequence number. When given, an odd number of
        dropped messages flips the optimization phase so that the cadence
        holds, and a drop seen on an optimization message makes the node
        optimize twice in a row to catch the reference up. (The window is
        indexed by time, so the reference index needs no adjustment.)
        """
        x = np.asarray(x)
        self._msg_count += 1
        if self.phase == MissionPhase.OFF:
            # Motors off: clear the held command so that the gating can
            # never replay a stale pre-landing thrust.
            self._last_u = np.zeros(4)
            return self._last_u

        if seq is not None:
            skipped = 0
            if self._last_seq is not None:
                skipped = max(int(seq) - self._last_seq - 1, 0)
                self.n_skipped += skipped
            self._last_seq = int(seq)
            if not self._optimize_next:
                if skipped % 2 == 1:
                    self._optimize_next = False  # odd drop count: optimize now
                else:
                    self._optimize_next = True
                    return self._last_u
            else:
                # A drop on an optimization message: this one and the next.
                self._optimize_next = skipped > 0
        elif (self._msg_count - 1) % self.optimize_every != 0:
            return self._last_u

        if self.phase == MissionPhase.HOVER:
            if self._hover_point is None:
                self._hover_point = x[:3].copy()
            ref, u_ref = self._point_reference(self._hover_point)

        elif self.phase == MissionPhase.ASCEND:
            start = self._traj[0, :3]
            ref, u_ref = self._point_reference(start)
            if (np.linalg.norm(x[:3] - start) < 0.15
                    and np.linalg.norm(x[7:10]) < 0.5):
                self.phase = MissionPhase.TRACK
                self._track_t0 = t

        elif self.phase == MissionPhase.TRACK:
            t_rel = t - self._track_t0
            if t_rel >= self._t_ref[-1]:
                self.phase = MissionPhase.LAND
                ref, u_ref = self._point_reference(
                    np.array([x[0], x[1], self.land_z]))
            else:
                ref, u_ref = self._reference_window(t_rel)
                i = min(int(np.searchsorted(self._t_ref, t_rel)), len(self._traj) - 1)
                self._track_err2.append(float(np.sum((x[:3] - self._traj[i, :3]) ** 2)))

        else:  # LAND (OFF returned above)
            ref, u_ref = self._point_reference(np.array([x[0], x[1], self.land_z]))
            if x[2] < self.land_z + 0.05 and np.linalg.norm(x[7:10]) < 0.3:
                self.phase = MissionPhase.OFF

        tic = time.perf_counter()
        self.mpc.set_reference(ref, u_ref)
        us, xs = self.mpc.optimize(x)
        u, self.last_xs = fetch_solution(us, xs)
        self.solve_s.append(time.perf_counter() - tic)
        self.n_optimized += 1

        if self.record and self.phase == MissionPhase.TRACK:
            self.records.append({
                "state_in": x,
                "input": u,
                "dt": self.control_period * self.optimize_every,
                "t": t,
            })

        self._last_u = u
        return u

    # ------------------------------------------------------------- reporting

    def tracking_rmse(self) -> float:
        if not self._track_err2:
            return float("nan")
        return float(np.sqrt(np.mean(self._track_err2)))

    def nominal_prediction(self, x_in, u) -> np.ndarray:
        """(m, 13) float64: each row's nominal-model state one control
        period on, RK4 at 0.5 ms sub-steps (40 at 50 Hz), on the host: all
        rows in one batched pass, not once per message."""
        x = torch.as_tensor(np.asarray(x_in, np.float64))
        u = torch.as_tensor(np.asarray(u, np.float64))
        return discrete_step(self._nominal, self.control_period, self._nominal_steps,
                             x, u, x.new_zeros((x.shape[0], 0))).numpy()

    def recording_arrays(self):
        """The recording as (x_in, u, x_out, x_pred, dt) arrays for the GP
        dataset pipeline, x_out paired from the next row, x_pred the
        nominal prediction of each row; None below two rows."""
        if len(self.records) < 2:
            return None
        rows, nxt = self.records[:-1], self.records[1:]
        x_in = np.stack([r["state_in"] for r in rows])
        u = np.stack([r["input"] for r in rows])
        x_pred = self.nominal_prediction(x_in, u)
        x_out = np.stack([r["state_in"] for r in nxt])
        dt = np.asarray([r["dt"] for r in rows])
        return x_in, u, x_out, x_pred, dt
