"""The port stands alone: no JAX, nothing of ``ad_mpc_tpu``, not the
root ``bench.py`` and none of scikit-learn, joblib or matplotlib (which
the machine with the card lacks) inside it, and no silent CPU path when
the card is missing."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from ad_mpc_tpu_torch import fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import pkgutil, sys
import ad_mpc_tpu_torch
for m in pkgutil.walk_packages(ad_mpc_tpu_torch.__path__, "ad_mpc_tpu_torch."):
    __import__(m.name)
import chip_smoke
refused = ("jax", "ad_mpc_tpu", "sklearn", "joblib", "matplotlib")
bad = sorted(m for m in sys.modules if m.split(".")[0] in refused or m == "bench")
port = sorted(m for m in sys.modules if m.startswith("ad_mpc_tpu_torch"))
print(len(port), bad, " ".join(port))
sys.exit(1 if bad else 0)
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    res = _run(["-c", _PROBE], REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 85  # every module of the port was imported
    for m in ("models.quadrotor", "experiments.quad_fleet",
              "experiments.quad_kernels", "utils.math", "models.pacejka",
              "models.gp_bicycle", "learned.gp", "learned.ensemble",
              "learned.lane", "experiments.bicycle_kernels", "models.gp_quad",
              "experiments.gp_quad_anchor", "control.reference",
              "control.safety", "sim.simulator", "runtime.bridge",
              "nodes.topics", "nodes.ad_node", "nodes.sim_node",
              "experiments.ad_closed_loop", "experiments.deployment_loop",
              "control.mpc", "trajectories.keyframes", "trajectories.polynomial",
              "trajectories.quad_refs", "experiments.quad_trajectory_test",
              "utils.io", "utils.metrics", "utils.visualization", "utils.live_viz",
              "learned.cluster", "learned.dataset", "learned.rdrv",
              "learned.fitting", "ocp.propagation", "models.gp_routed",
              "experiments.record_dataset", "experiments.comparative",
              "experiments.gp_flagship", "experiments.gp_visualization",
              "experiments.routed_fleet", "nodes.quad_wrapper",
              "nodes.reference_publisher", "nodes.quad_node", "nodes.quad_controller",
              "utils.animator", "experiments.quad_mission", "parallel",
              "parallel.mesh", "parallel.batch", "parallel.multihost",
              "parallel.scaling", "entry"):
        assert f"ad_mpc_tpu_torch.{m}" in res.stdout.split()


def test_build_fleet_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.build_fleet(fleet.dynamic_bicycle, fleet.switch_on, n_nodes=4)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(where, tmp_path):
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    res = _run(["chip_smoke.py"], cwd)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
