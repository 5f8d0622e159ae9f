"""The port's learned-pipeline experiments and utilities on the CPU: a
tiny comparative sweep and a tiny flagship run (record -> fit -> sweep) on
the plain backend under a temporary results root, the model registry's
``.npz`` round trip, the result registry and the numbers of
the GP plots (held to the JAX package's ensemble functions at 1e-9).

Nothing here writes under the repository's ``results/``."""

import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ad_mpc_tpu.learned import ensemble as je
from ad_mpc_tpu_torch.experiments import comparative, gp_flagship, quad_fleet
from ad_mpc_tpu_torch.experiments.gp_visualization import gp_bands
from ad_mpc_tpu_torch.learned.ensemble import GPEnsemble
from ad_mpc_tpu_torch.utils import io, visualization
from ad_mpc_tpu_torch.utils.live_viz import ExperimentRegistry
from ad_mpc_tpu_torch.testing import one_thread  # noqa: F401 (autouse)


REPO = Path(__file__).resolve().parents[1]


def _results_listing():
    return sorted((str(p), p.stat().st_mtime) for p in (REPO / "results").rglob("*"))


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("AD_MPC_TORCH_RESULTS_DIR", str(tmp_path / "results"))
    monkeypatch.setenv("AD_MPC_TORCH_DATA_DIR", str(tmp_path / "data"))
    before = _results_listing()
    yield tmp_path
    assert _results_listing() == before, "wrote under the repository's results/"


def test_comparative_sweep_writes_under_its_root(root):
    rmse, t_opt, v_max = comparative.comparative_sweep(
        {"nominal": {"max_steps": 3}, "rdrv": {"max_steps": 3,
                                               "rdrv_d": quad_fleet.fitted_rdrv_d()}},
        traj_types=("loop",), speeds=(8.0,), save_name="tiny", device="cpu")
    assert rmse.shape == t_opt.shape == v_max.shape == (2, 1, 1)
    assert np.isfinite(rmse).all() and np.isfinite(t_opt).all()
    d = root / "results" / "experiments"
    assert (d / "tiny" / "mse.npy").exists()
    reg = ExperimentRegistry(str(d / "metadata.json"))
    assert reg.lookup("loop", "rdrv", 8.0)["n_runs"] == 1
    assert "rdrv" in reg.table("loop")


def test_gp_flagship_tiny_run(root):
    """Record 2 targets, fit both candidates, sweep one cell per model: at
    most 3 control periods per closed-loop run."""
    gp_flagship.main(["--tag", "_tiny", "--targets", "2", "--points", "8",
                      "--restarts", "1", "--max-steps", "3", "--traj", "loop",
                      "--speeds", "8", "--device", "cpu"])
    d = root / "results" / "experiments" / "gp_flagship_tiny"
    rec = json.loads((d / "record_meta.json").read_text())
    assert rec["n_samples"] == 6 and np.isfinite(rec["v_max"])
    fit = json.loads((d / "fit_meta.json").read_text())
    assert set(fit["offline_heldout"]["candidates"]) == {"1", "2"}
    assert len(fit["rdrv_diag"]) == 3
    summary = json.loads((d / "sweep_summary.json").read_text())
    assert summary["model"] == "fitted"
    assert np.asarray(summary["rmse"]).shape == (3, 1, 1)
    assert np.isfinite(np.asarray(summary["rmse"])).all()
    ens, rdrv_d = gp_flagship.load_fitted("_tiny")
    assert isinstance(ens, GPEnsemble) and rdrv_d.shape == (3, 3)
    assert io.load_model("gp_flagship_tiny_c2").n_clusters == 2
    carried, d_carried = gp_flagship.load_fitted(model="carried")
    assert carried.x_train.shape == (3, 1, 60, 3)
    np.testing.assert_array_equal(d_carried, quad_fleet.fitted_rdrv_d())


def test_model_registry_round_trip(root):
    ens = quad_fleet.make_quad_gp_ensemble(n=8, clusters=2)
    io.save_model(ens, "ens", metadata={"k": 1})
    io.save_model(np.diag([1.0, 2.0, 3.0]), "drag")
    back = io.load_model("ens")
    for name in GPEnsemble._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(ens, name)))
    np.testing.assert_array_equal(io.load_model("drag"), np.diag([1.0, 2.0, 3.0]))
    d = io.dataset_dir("flights", "train", {"seed": 3}, create=True)
    io.save_arrays(d, a=np.arange(3))
    assert io.dataset_dir("flights", "train", {"seed": 3}) == d
    np.testing.assert_array_equal(io.load_arrays(d)["a"], np.arange(3))
    with pytest.raises(FileNotFoundError):
        io.dataset_dir("flights", "train", {"seed": 4})
    assert io.git_hash()


def test_gp_plot_numbers_match_jax():
    """The GP plot's means, variances and +-3 sigma bands against the JAX
    package's ``predict`` and ``predict_variance`` at 1e-9."""
    ens = quad_fleet.make_quad_gp_ensemble(n=8, clusters=2)
    ej = je.GPEnsemble(*(jnp.asarray(getattr(ens, k)) if k not in ("out_idx", "feat_idx")
                         else getattr(ens, k) for k in je.GPEnsemble._fields))
    z = np.random.default_rng(2).normal(1.0, 3.0, (5, 3))
    mu, var, lo, hi = gp_bands(ens, z)
    mu_j = np.stack([np.asarray(je.predict(ej, jnp.asarray(zz))) for zz in z])
    var_j = np.stack([np.asarray(je.predict_variance(ej, jnp.asarray(zz))) for zz in z])
    np.testing.assert_allclose(mu, mu_j, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(var, var_j, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(hi - lo, 6.0 * np.sqrt(var_j), rtol=1e-9)
    w, h, _ = visualization.ellipse_axes(np.diag([4.0, 1.0]))
    np.testing.assert_allclose((w, h), (12.0, 6.0))
    err = visualization.tracking_errors([0.0, 1.0], np.ones((2, 13)), np.zeros((2, 13)))
    np.testing.assert_array_equal(err, np.ones((2, 3)))
