"""Port parity for the live views (``ad_mpc_tpu/utils/live_viz.py``'s
plotters and ``utils/animator.py``), run as ``tests/test_live_viz.py`` and
``tests/test_observability.py`` run them: frames, a snapshot and a GIF in
``tmp_path``, each artist holding the JAX package's data for the same
frames."""

import os

import numpy as np
import pytest

from ad_mpc_tpu.utils import animator as janim
from ad_mpc_tpu.utils import live_viz as jviz
from ad_mpc_tpu_torch.utils import animator as tanim
from ad_mpc_tpu_torch.utils import live_viz as tviz


def _quad_frames():
    rng = np.random.default_rng(2)
    for k in range(5):
        x = np.zeros(13)
        x[0] = 0.04 * k
        x[2] = 1.0
        q = np.array([1.0, 0.0, 0.0, 0.0]) + 0.2 * rng.normal(size=4)
        x[3:7] = q / np.linalg.norm(q)
        pred = np.zeros((10, 13))
        pred[:, 0] = x[0] + np.linspace(0, 0.5, 10)
        pred[:, 2] = 1.0
        yield x, pred


def test_quad_plotter_frames_and_snapshot(tmp_path):
    plotters = [viz.LiveQuadPlotter(interactive=False, trail_len=4)
                for viz in (tviz, jviz)]
    traj = np.zeros((50, 3))
    traj[:, 0] = np.linspace(0, 2, 50)
    traj[:, 2] = 1.0
    for p in plotters:
        p.set_reference(traj)
    for x, pred in _quad_frames():
        for p in plotters:
            p.update(x, pred_xs=pred)
    port, jax_p = plotters
    for name in ("_arm1", "_arm2", "_trail_line", "_pred_line", "_ref_line"):
        for a, b in zip(getattr(port, name).get_data_3d(),
                        getattr(jax_p, name).get_data_3d()):
            np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)
    for a, b in zip(port._rotors._offsets3d, jax_p._rotors._offsets3d):
        np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)
    assert len(port._trail) == 4  # bounded by trail_len, artists reused
    out = port.snapshot(str(tmp_path / "frame.png"))
    assert os.path.getsize(out) > 1000
    for p in plotters:
        p.close()


def test_vehicle_plotter_frames(tmp_path):
    track = np.stack([np.linspace(0, 50, 100), np.zeros(100)], axis=1)
    plotters = [viz.LiveVehiclePlotter(track_xy=track, interactive=False)
                for viz in (tviz, jviz)]
    for k in range(4):
        x = np.zeros(7)
        x[0], x[2], x[3] = 2.0 * k, 0.1 * k, 8.0
        pred = np.stack([x[0] + np.arange(5.0), np.full(5, 0.3 * k)], axis=1)
        for p in plotters:
            p.update(x, pred_xs=pred)
    for name in ("_body", "_trail_line", "_pred_line"):
        for a, b in zip(getattr(plotters[0], name).get_data(),
                        getattr(plotters[1], name).get_data()):
            np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)
    out = plotters[0].snapshot(str(tmp_path / "veh.png"))
    assert os.path.getsize(out) > 1000
    for p in plotters:
        p.close()


@pytest.mark.parametrize("with_ref", [True, False])
def test_animator_saves_gif(tmp_path, with_ref):
    t = np.linspace(0, 2 * np.pi, 120)
    xs = np.stack([np.cos(t), np.sin(t), 1.0 + 0.1 * t], axis=1)
    ref = np.stack([np.cos(t), np.sin(t), np.ones_like(t)], axis=1) if with_ref else None
    anim = tanim.Dynamic3DTrajectory(xs, ref, speedup=1)
    out = anim.save(str(tmp_path / "replay.gif"), max_frames=30)
    assert os.path.getsize(out) > 1000
    want = janim.Dynamic3DTrajectory(xs, ref, speedup=1)
    want.save(str(tmp_path / "replay_jax.gif"), max_frames=30)
    assert anim.speedup == want.speedup == 4  # the stride raised to 30 frames
