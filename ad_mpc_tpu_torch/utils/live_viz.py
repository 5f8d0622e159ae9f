"""Live visualization artists and the experiments' result registry (port
of ``ad_mpc_tpu/utils/live_viz.py``).

- :class:`LiveQuadPlotter`: the drone animation of
  ``ros_gp_mpc/src/utils/visualization.py:31-459``: persistent matplotlib
  artists (the drone's arms and rotors, the flown trail, the reference path,
  the MPC horizon) updated in place per frame; ``snapshot()`` writes a frame.
- :class:`LiveVehiclePlotter`: the AD counterpart (footprint and heading,
  track, horizon) of the RViz MarkerArray stream (``gp_ad_mpc_node.py:269-341``).
- :class:`ExperimentRegistry`: the persistent ``metadata.json`` of RMSE and
  opt-time means across runs, keyed by (trajectory, model, speed)
  (``gp_mpc_node.py:556-599``).

The plotters import matplotlib when they are made (headless, Agg, unless
``interactive`` and a display), so that the module imports where matplotlib
is missing; making a plotter there raises ``ImportError``.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch

from ad_mpc_tpu_torch.utils.math import q_to_rot_mat


def _plt(interactive: bool):
    import matplotlib

    if not interactive or not os.environ.get("DISPLAY"):
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


class LiveQuadPlotter:
    """Persistent-artist 3D drone animation."""

    def __init__(self, world_rad: float = 3.0, arm_length: float = 0.24,
                 trail_len: int = 400, interactive: bool = False):
        plt = _plt(interactive)
        self._plt = plt
        self.interactive = interactive and bool(os.environ.get("DISPLAY"))
        self.trail_len = trail_len
        self.arm = arm_length

        self.fig = plt.figure(figsize=(7, 6))
        self.ax = self.fig.add_subplot(111, projection="3d")
        self.ax.set_xlim(-world_rad, world_rad)
        self.ax.set_ylim(-world_rad, world_rad)
        self.ax.set_zlim(0, world_rad)
        self.ax.set_xlabel("x [m]")
        self.ax.set_ylabel("y [m]")
        self.ax.set_zlabel("z [m]")

        (self._ref_line,) = self.ax.plot([], [], [], "g--", lw=1, label="reference")
        (self._trail_line,) = self.ax.plot([], [], [], "b-", lw=1, label="flown")
        (self._pred_line,) = self.ax.plot([], [], [], "r-", lw=1.5,
                                          label="MPC horizon")
        (self._arm1,) = self.ax.plot([], [], [], "k-", lw=2)
        (self._arm2,) = self.ax.plot([], [], [], "k-", lw=2)
        self._rotors = self.ax.scatter([], [], [], c="k", s=12)
        self.ax.legend(loc="upper right")
        self._trail: list[np.ndarray] = []
        if self.interactive:
            plt.ion()
            self.fig.show()

    def set_reference(self, traj):
        traj = np.asarray(traj)
        self._ref_line.set_data(traj[:, 0], traj[:, 1])
        self._ref_line.set_3d_properties(traj[:, 2])

    def update(self, x, pred_xs=None):
        """One frame: the 13D state x and optionally the (H, 13) prediction."""
        x = np.asarray(x)
        p, q = x[:3], x[3:7]
        R = q_to_rot_mat(torch.as_tensor(q, dtype=torch.float64)).numpy()
        h = self.arm
        # The x-configuration's arm tips, body frame -> world.
        tips = (R @ np.array([[h, -h, -h, h], [-h, -h, h, h],
                              [0.0, 0.0, 0.0, 0.0]])).T + p
        self._arm1.set_data([tips[0, 0], tips[2, 0]], [tips[0, 1], tips[2, 1]])
        self._arm1.set_3d_properties([tips[0, 2], tips[2, 2]])
        self._arm2.set_data([tips[1, 0], tips[3, 0]], [tips[1, 1], tips[3, 1]])
        self._arm2.set_3d_properties([tips[1, 2], tips[3, 2]])
        self._rotors._offsets3d = (tips[:, 0], tips[:, 1], tips[:, 2])

        self._trail.append(p.copy())
        if len(self._trail) > self.trail_len:
            self._trail.pop(0)
        tr = np.asarray(self._trail)
        self._trail_line.set_data(tr[:, 0], tr[:, 1])
        self._trail_line.set_3d_properties(tr[:, 2])
        if pred_xs is not None:
            pr = np.asarray(pred_xs)
            self._pred_line.set_data(pr[:, 0], pr[:, 1])
            self._pred_line.set_3d_properties(pr[:, 2])
        if self.interactive:
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()

    def snapshot(self, path: str):
        self.fig.canvas.draw()
        self.fig.savefig(path, dpi=90)
        return path

    def close(self):
        self._plt.close(self.fig)


class LiveVehiclePlotter:
    """Persistent-artist 2D vehicle animation (the RViz marker role)."""

    def __init__(self, track_xy=None, interactive: bool = False,
                 trail_len: int = 600, length: float = 4.5, width: float = 1.9):
        plt = _plt(interactive)
        self._plt = plt
        self.interactive = interactive and bool(os.environ.get("DISPLAY"))
        self.trail_len = trail_len
        self.L, self.W = length, width

        self.fig, self.ax = plt.subplots(figsize=(7, 6))
        self.ax.set_aspect("equal")
        if track_xy is not None:
            t = np.asarray(track_xy)
            self.ax.plot(t[:, 0], t[:, 1], "g--", lw=1, label="track")
        (self._trail_line,) = self.ax.plot([], [], "b-", lw=1, label="driven")
        (self._pred_line,) = self.ax.plot([], [], "r-", lw=1.5, label="MPC horizon")
        (self._body,) = self.ax.plot([], [], "k-", lw=2)
        self.ax.legend(loc="upper right")
        self._trail: list[np.ndarray] = []
        if self.interactive:
            plt.ion()
            self.fig.show()

    def update(self, x, pred_xs=None):
        """x: the 7D bicycle state; pred_xs: optionally the (H, 7) prediction."""
        x = np.asarray(x)
        px, py, psi = x[0], x[1], x[2]
        c, s = np.cos(psi), np.sin(psi)
        hl, hw = self.L / 2, self.W / 2
        corners = np.array([[hl, hw], [hl, -hw], [-hl, -hw], [-hl, hw], [hl, hw],
                            [hl * 1.4, 0.0], [hl, -hw]])  # the nose marks the heading
        world = corners @ np.array([[c, s], [-s, c]]) + [px, py]
        self._body.set_data(world[:, 0], world[:, 1])

        self._trail.append(np.array([px, py]))
        if len(self._trail) > self.trail_len:
            self._trail.pop(0)
        tr = np.asarray(self._trail)
        self._trail_line.set_data(tr[:, 0], tr[:, 1])
        if pred_xs is not None:
            pr = np.asarray(pred_xs)
            self._pred_line.set_data(pr[:, 0], pr[:, 1])
        self.ax.relim()
        self.ax.autoscale_view()
        if self.interactive:
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()

    def snapshot(self, path: str):
        self.fig.canvas.draw()
        self.fig.savefig(path, dpi=90)
        return path

    def close(self):
        self._plt.close(self.fig)


class ExperimentRegistry:
    """A persistent cross-run result registry: nested {traj_type: {model:
    {speed: {rmse, t_opt_ms, n_runs}}}}, each cell a running mean over the
    runs recorded, in a JSON file."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self.data: dict = {}
        if os.path.exists(path):
            with open(path) as f:
                self.data = json.load(f)

    def record(self, traj_type: str, model: str, speed: float,
               rmse: float, t_opt_ms: float):
        key_speed = f"{float(speed):g}"
        with self._lock:
            node = (self.data.setdefault(traj_type, {})
                    .setdefault(model, {})
                    .setdefault(key_speed, {"rmse": 0.0, "t_opt_ms": 0.0,
                                            "n_runs": 0}))
            n = node["n_runs"]
            node["rmse"] = (node["rmse"] * n + float(rmse)) / (n + 1)
            node["t_opt_ms"] = (node["t_opt_ms"] * n + float(t_opt_ms)) / (n + 1)
            node["n_runs"] = n + 1
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "w") as f:
                json.dump(self.data, f, indent=1, sort_keys=True)

    def lookup(self, traj_type: str, model: str, speed: float):
        return self.data.get(traj_type, {}).get(model, {}).get(f"{float(speed):g}")

    def table(self, traj_type: str) -> str:
        """A table of models by speeds: ``rmse m/t_opt ms`` per cell."""
        models = sorted(self.data.get(traj_type, {}))
        speeds = sorted({s for m in models for s in self.data[traj_type][m]},
                        key=float)
        lines = [f"{'model':<18}" + "".join(f"{('v=' + s):>14}" for s in speeds)]
        for m in models:
            cells = []
            for s in speeds:
                e = self.data[traj_type][m].get(s)
                cells.append(f"{e['rmse']:.3f}m/{e['t_opt_ms']:.1f}ms" if e else "-")
            lines.append(f"{m:<18}" + "".join(f"{c:>14}" for c in cells))
        return "\n".join(lines)
