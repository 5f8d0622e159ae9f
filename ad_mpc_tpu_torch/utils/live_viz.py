"""The experiments' result registry.

Port of ``ad_mpc_tpu/utils/live_viz.py:192-249``, ``ExperimentRegistry``
alone, which the comparative sweep writes; the live plotters are not
ported yet.
"""

from __future__ import annotations

import json
import os
import threading


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
