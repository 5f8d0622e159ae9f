"""The port's flight recorder (``experiments/record_dataset.py``) on the
CPU, in its deterministic parts: the plant step and nominal prediction of
every sample of the JAX package's committed flagship recording, and the
recorder's walk through targets, timeouts and resets, driven by one
scripted controller and plant in both packages. (The recorded flights
themselves depend on the IPM's rounding after a few samples: no test
compares them beyond that.)"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ad_mpc_tpu.experiments import record_dataset as jrd
from ad_mpc_tpu.models.quadrotor import QuadrotorParams as JaxQuadParams
from ad_mpc_tpu.models.quadrotor import quad_dynamics as jax_quad_dynamics
from ad_mpc_tpu.ops.integrators import discretize as jax_discretize
from ad_mpc_tpu.sim.simulator import DisturbanceConfig as JaxDist
from ad_mpc_tpu.sim.simulator import QuadrotorSim as JaxQuadSim
from ad_mpc_tpu_torch.experiments import record_dataset as trd
from ad_mpc_tpu_torch.testing import one_thread  # noqa: F401 (autouse)

COMMITTED = (Path(__file__).resolve().parents[1] / "results" / "experiments"
             / "gp_flagship" / "dataset" / "data.npz")
# The committed recording was made in float32: the port's float64 replay
# lands within 2.9e-6 (x_pred) and 6.7e-6 (x_out) of it.
REPLAY_TOL = 1e-5


def test_replay_matches_the_committed_recording():
    """Every committed (x_in, u), the non-finite sample included: the
    port's plant step and nominal prediction against the recorded x_out
    and x_pred at REPLAY_TOL; and against the JAX package's own plant and
    predictor in float64 at 1e-9 on a spread of rows."""
    with np.load(COMMITTED) as z:
        rec = dict(z)
    x_out, x_pred = trd.replay(rec["x_in"], rec["u"])
    for got, want in ((x_out, rec["x_out"]), (x_pred, rec["x_pred"])):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.nanmax(np.abs(got - want)) <= REPLAY_TOL
    rows = np.arange(0, len(rec["x_in"]), 59)
    jsim = JaxQuadSim(params=JaxQuadParams(), disturbances=JaxDist(drag=True), sim_dt=1e-3)
    f_nom = jax.jit(jax_discretize(lambda x, u: jax_quad_dynamics(x, u, JaxQuadParams()),
                                   0.02, 4))
    key = jax.random.PRNGKey(0)
    for i in rows:
        x, u = (jnp.asarray(rec[k][i], jnp.float64) for k in ("x_in", "u"))
        np.testing.assert_allclose(x_out[i], np.asarray(jsim.step(x, u, key, 0.02)[0]),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(x_pred[i], np.asarray(f_nom(x, u)), rtol=0, atol=1e-9)


class _Script:
    """A scripted controller: per target k, plan k % 5 commands the position
    a stand-in plant jumps to. 0 and 4 halve the distance to the target
    (it is reached), 1 backs away from it (the 2 s limit), 2 leaves the
    box after 3 steps and 3 gives a non-finite state after 2 (resets)."""

    def __init__(self, box):
        self.box, self.targets, self.resets, self.step = box, [], [], 0

    def set_reference(self, xref, uref):
        self.targets.append(np.array(xref, np.float64)[0, :3])
        self.step = 0

    def reset(self):
        self.resets.append(len(self.targets) - 1)

    def command(self, x):
        plan, j = (len(self.targets) - 1) % 5, self.step
        self.step += 1
        pos = np.array(x, np.float64)[:3]
        to = self.targets[-1] - pos
        nan = 0.0
        if plan in (0, 4):
            nxt = pos + 0.5 * to
        elif plan == 1:
            nxt = pos - 0.01 * to / np.linalg.norm(to)
        else:
            nxt = pos + 0.1 * to
            if plan == 2 and j >= 3:
                nxt = np.full(3, 10.0 * self.box)
            nan = float(plan == 3 and j >= 2)
        return np.r_[nxt, nan]


def _plant(x, u):
    """The stand-in plant: the commanded position, the velocity that takes
    it there in a control period; all NaN when the command's flag is set."""
    x, u = np.array(x, np.float64), np.asarray(u, np.float64)
    if u[3] > 0.5:
        return np.full(13, np.nan)
    x[7:10] = (u[:3] - x[:3]) / 0.02
    x[:3] = u[:3]
    return x


def _stand_ins(script, tensor, with_key):
    class MPC:
        def __init__(self, **kw):
            pass

        set_reference, reset = script.set_reference, script.reset

        def optimize(self, x):
            return tensor(np.tile(script.command(x), (10, 1))), None

    class Sim:
        def __init__(self, **kw):
            pass

        if with_key:
            def step(self, x, u, key, dt):
                return tensor(_plant(x, u)), key
        else:
            def step(self, x, u, dt):
                return tensor(_plant(x, u))

    return MPC, Sim


def test_recorder_walk_matches_jax(monkeypatch):
    """The same scripted controller and plant in both packages' recorders:
    the same targets, resets and recorded rows (x_in, u, x_out, dt equal,
    x_pred at 1e-12 relative), and ``flight_segments`` reads the script's
    walk back."""
    n_targets, box = 6, 4.0
    scripts = {}
    for mod, tensor, with_key in ((trd, torch.as_tensor, False), (jrd, jnp.asarray, True)):
        scripts[mod] = _Script(box)
        mpc, sim = _stand_ins(scripts[mod], tensor, with_key)
        monkeypatch.setattr(mod, "QuadMPC", mpc)
        monkeypatch.setattr(mod, "QuadrotorSim", sim)
    got = trd.record_flights(n_targets=n_targets, box=box, seed=3, device="cpu")
    want = jrd.record_flights(n_targets=n_targets, box=box, seed=3)
    s_t, s_j = scripts[trd], scripts[jrd]
    np.testing.assert_array_equal(np.stack(s_t.targets), np.stack(s_j.targets))
    assert s_t.resets == s_j.resets == [2, 3]
    for k in ("x_in", "u", "x_out", "dt"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["x_pred"], want["x_pred"], rtol=1e-12, atol=0)
    segs = trd.flight_segments(got, n_targets, box, seed=3)
    assert [s["end"] for s in segs] == ["target", "limit", "reset", "reset", "target",
                                        "target"]
    assert [s["samples"] for s in segs][1:4] == [100, 3, 2]
    assert sum(s["samples"] for s in segs) == len(got["x_in"])
