"""Animated 3D replay of a flown trajectory (port of
``ad_mpc_tpu/utils/animator.py``; the reference's ``Dynamic3DTrajectory``,
``ros_gp_mpc/src/utils/animator.py:21``).

matplotlib is imported when an animation is built (headless, Agg), so that
the module imports where matplotlib is missing; building one there raises
``ImportError``.
"""

from __future__ import annotations

import numpy as np


class Dynamic3DTrajectory:
    """Animated replay of the executed 3D positions against the reference's."""

    def __init__(self, x_executed, x_ref=None, speedup: int = 4):
        self.pos = np.asarray(x_executed)[:, :3]
        self.ref = None if x_ref is None else np.asarray(x_ref)[:, :3]
        self.speedup = max(int(speedup), 1)

    def _setup(self):
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(6, 5))
        ax = fig.add_subplot(projection="3d")
        lo = self.pos.min(axis=0) - 0.5
        hi = self.pos.max(axis=0) + 0.5
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[1], hi[1])
        ax.set_zlim(lo[2], hi[2])
        if self.ref is not None:
            ax.plot(*self.ref.T, "--", color="gray", lw=1, label="reference")
        (line,) = ax.plot([], [], [], "b-", lw=1.5, label="executed")
        (dot,) = ax.plot([], [], [], "ro", ms=5)
        ax.legend()
        return fig, ax, line, dot

    def animate(self):
        """The ``FuncAnimation`` of the replay."""
        from matplotlib.animation import FuncAnimation

        fig, ax, line, dot = self._setup()
        frames = range(1, len(self.pos), self.speedup)

        def update(i):
            line.set_data(self.pos[:i, 0], self.pos[:i, 1])
            line.set_3d_properties(self.pos[:i, 2])
            dot.set_data([self.pos[i - 1, 0]], [self.pos[i - 1, 1]])
            dot.set_3d_properties([self.pos[i - 1, 2]])
            return line, dot

        return FuncAnimation(fig, update, frames=frames, interval=30, blit=False)

    def save(self, path: str, fps: int = 20, max_frames: int = 200):
        """Render to a GIF, the stride raised to keep ``max_frames``."""
        from matplotlib.animation import PillowWriter

        n_frames = len(range(1, len(self.pos), self.speedup))
        if n_frames > max_frames:
            self.speedup = max(len(self.pos) // max_frames, 1)
        anim = self.animate()
        anim.save(path, writer=PillowWriter(fps=fps))
        return path
