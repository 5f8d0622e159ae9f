"""The JAX package's quadrotor tracking rows that ``chip_smoke.py`` holds
the port's ``quad_residual_fn`` rows to (``JAX_QUAD_RMSE``): its
``run_tracking`` on the loop at 8 m/s, all its ticks, under the
flagship's drag (deterministic), float32, with ``quad_residual_fn`` of the
fitted one-cluster ``gp_flagship_c1`` and of the fitted two-cluster
``gp_flagship_c2`` (the nearest centroid at every evaluation, and pinned to
cluster 1), and with the fitted RDRv drag beside the one-cluster GP (as
``ensemble=`` and as ``quad_residual_fn``); the port's copies in
``ad_mpc_tpu_torch/data/``, read with numpy. Run on a CPU, from the
repository's root, for every row or for the rows named:

    JAX_PLATFORMS=cpu python tests/jax_quad_rows.py [row ...]

Prints one JSON line: {row: RMSE in m}. Not a test (no ``test_`` prefix):
a reference run of about a minute per row.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ad_mpc_tpu.experiments.quad_trajectory_test import run_tracking  # noqa: E402
from ad_mpc_tpu.learned import GPEnsemble  # noqa: E402
from ad_mpc_tpu.learned.ensemble import quad_residual_fn  # noqa: E402
from ad_mpc_tpu.sim.simulator import DisturbanceConfig  # noqa: E402

DATA = Path(__file__).resolve().parents[1] / "ad_mpc_tpu_torch" / "data"


def ensemble(name):
    """The JAX package's GPEnsemble of ``ad_mpc_tpu_torch/data/<name>.npz``."""
    with np.load(DATA / f"{name}.npz") as z:
        f = {k: z[k] for k in z.files}
    idx = {k: tuple(int(i) for i in f.pop(k)) for k in ("out_idx", "feat_idx")}
    return GPEnsemble(**{k: jnp.asarray(v) for k, v in f.items()}, **idx)


def modes():
    """{row: run_tracking keywords}, as ``chip_smoke.quad_modes`` names them."""
    c1, c2 = ensemble("gp_flagship_c1"), ensemble("gp_flagship_c2")
    D = jnp.asarray(np.load(DATA / "rdrv_d.npy"))
    return {"residual_fn": {"residual_fn": quad_residual_fn(c1)},
            "residual_fn_c2": {"residual_fn": quad_residual_fn(c2)},
            "residual_fn_c2_pinned": {"residual_fn": quad_residual_fn(c2, 1)},
            "rdrv_gp": {"rdrv_d": D, "ensemble": c1},
            "rdrv_residual_fn": {"rdrv_d": D, "residual_fn": quad_residual_fn(c1)}}


def main(names):
    every = modes()
    rows = {}
    for row in names or every:
        res = run_tracking(disturbances=DisturbanceConfig(drag=True), **every[row])
        rows[row] = res.rmse
    print(json.dumps(rows))


if __name__ == "__main__":
    main(sys.argv[1:])
