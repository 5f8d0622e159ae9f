"""Port parity for the learned pipeline: the GP's likelihood, fit and
variance, the ensemble's variance, the port's own k-means, Gaussian
mixture and PCA, the residual dataset, the RDRv fit and the fitting
pipeline.

Every input is drawn from a seed with numpy and handed to both packages;
the JAX side runs on the CPU in float64. Tolerances: the likelihood and
its gradient 1e-9, the fit 1e-6 relative (two L-BFGS-B runs on gradients
that agree to rounding), the variances 1e-9, the dataset and the RDRv
fit 1e-12; k-means and the mixture, which the JAX package takes from
scikit-learn and the port draws with its own generator, are held to the
same partition and selections on well-separated blobs, and the mixture's
memberships to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ad_mpc_tpu.learned import dataset as jd
from ad_mpc_tpu.learned import ensemble as je
from ad_mpc_tpu.learned import fitting as jf
from ad_mpc_tpu.learned import gp as jg
from ad_mpc_tpu.learned.rdrv import fit_rdrv as jax_fit_rdrv
from ad_mpc_tpu_torch.learned import cluster as tc
from ad_mpc_tpu_torch.learned import dataset as td
from ad_mpc_tpu_torch.learned import ensemble as te
from ad_mpc_tpu_torch.learned import fitting as tf
from ad_mpc_tpu_torch.learned import gp as tg
from ad_mpc_tpu_torch.learned.rdrv import fit_rdrv
from ad_mpc_tpu_torch.testing import one_thread  # noqa: F401 (autouse)


def _gp_data(seed=3, n=25, d=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, (n, d))
    y = np.sin(x[:, 0]) - 0.3 * x[:, 1] ** 2 + 0.05 * rng.normal(size=n)
    return x, y


def test_nll_and_gradient_match_jax():
    x, y = _gp_data()
    yc = y - y.mean()
    theta = np.array([0.2, -0.1, 0.4, -0.5, -2.0])
    v_j, g_j = jax.value_and_grad(lambda t: jg._nll(t, x, yc))(jnp.asarray(theta))
    t = torch.tensor(theta, requires_grad=True)
    v = tg._nll(t, torch.as_tensor(x), torch.as_tensor(yc))
    (g,) = torch.autograd.grad(v, t)
    np.testing.assert_allclose(float(v.detach()), float(v_j), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-9, atol=1e-9)


def test_fit_gp_matches_jax():
    """The same restarts, bounds and optimizer from the same seed."""
    x, y = _gp_data()
    want = jg.fit_gp(x, y, n_restarts=2, seed=1)
    got = tg.fit_gp(x, y, n_restarts=2, seed=1)
    for name in ("len_scale", "sigma_f", "sigma_n", "k_inv_y", "y_mean", "centroid"):
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(want, name)), rtol=1e-6,
                                   atol=1e-10, err_msg=name)


def test_predict_var_matches_jax():
    x, y = _gp_data()
    p = tg.fit_gp(x, y, n_restarts=1, seed=0)
    pj = jg.GPParams(*(jnp.asarray(np.asarray(v)) for v in p))
    for z in np.random.default_rng(5).uniform(-2.5, 2.5, (6, 3)):
        np.testing.assert_allclose(float(tg.predict_var(p, torch.as_tensor(z))),
                                   float(jg.predict_var(pj, jnp.asarray(z))),
                                   rtol=1e-9, atol=1e-12)


def _ensemble_gps(seed=11):
    """Two output dims x two clusters of 9 and 6 points: the smaller
    cluster's rows are padded in the ensemble."""
    rng = np.random.default_rng(seed)
    gps = [[], []]
    for dim in range(2):
        for c, n in enumerate((9, 6)):
            X = rng.uniform(-1, 1, (n, 2)) + 3.0 * c
            ls = np.array([0.8, 1.3])
            K = 0.4 * np.exp(-0.5 * np.sum(((X[:, None] - X[None]) / ls) ** 2, -1))
            y = np.cos(X[:, 0]) + 0.1 * dim
            K += (0.05**2 + 1e-8) * np.eye(n)
            gps[dim].append((X, np.linalg.solve(K, y - y.mean()), ls, 0.4, 0.05,
                             float(y.mean()), X.mean(axis=0)))
    return gps


def _both_ensembles(gps, feat_idx=(0, 1)):
    ej = je.GPEnsemble.from_gps([[jg.GPParams(*map(jnp.asarray, g)) for g in r]
                                 for r in gps], out_idx=(7, 8), feat_idx=feat_idx)
    et = te.GPEnsemble.from_gps([[tg.GPParams(*g) for g in r] for r in gps],
                                out_idx=(7, 8), feat_idx=feat_idx)
    return ej, et


def test_predict_variance_matches_jax_with_padded_rows():
    ej, et = _both_ensembles(_ensemble_gps())
    assert int(np.asarray(et.n_valid).min()) < et.x_train.shape[2]
    for z in np.random.default_rng(6).uniform(-1, 4, (8, 2)):
        got = te.predict_variance(et, torch.as_tensor(z)).numpy()
        want = np.asarray(je.predict_variance(ej, jnp.asarray(z)))
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_homogeneous_feature_space_matches_jax():
    gps = _ensemble_gps()
    for variant in (gps, [gps[0], gps[0]]):
        ej, et = _both_ensembles(variant)
        assert te.homogeneous_feature_space(et) == je.homogeneous_feature_space(ej)
    assert te.homogeneous_feature_space(_both_ensembles([gps[0], gps[0]])[1])


def _rollouts(seed=8, m=60):
    """Quad-like rollouts: unit quaternions, two dt=0 rows, one non-finite."""
    rng = np.random.default_rng(seed)

    def states():
        s = rng.normal(0.0, 2.0, (m, 13))
        q = rng.normal(size=(m, 4))
        s[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
        return s

    x_in, x_out, x_pred = states(), states(), states()
    u = rng.uniform(0, 1, (m, 4))
    dt = np.full(m, 0.02)
    dt[[3, 17]] = 0.0
    x_out[5, 8] = np.nan
    return x_in, u, x_out, x_pred, dt


def test_world_to_body_velocities_matches_jax():
    x = _rollouts()[0]
    np.testing.assert_allclose(td.world_to_body_velocities(x),
                               jd.world_to_body_velocities(x), rtol=0, atol=1e-12)


def test_dataset_from_rollouts_prune_split_and_rdrv_match_jax():
    args = _rollouts()
    dj = jd.ResidualDataset.from_rollouts(*args)
    dt_ = td.ResidualDataset.from_rollouts(*args)
    for name in ("x_in", "u", "y"):
        np.testing.assert_allclose(getattr(dt_, name), getattr(dj, name),
                                   rtol=1e-12, atol=1e-12, equal_nan=True)
    pj = dj.prune(vel_cap=4.0, hist_thresh=0.05)
    pt = dt_.prune(vel_cap=4.0, hist_thresh=0.05)
    assert 0 < len(pt.x_in) < len(dt_.x_in)
    for a, b in ((pt.x_in, pj.x_in), (pt.y, pj.y), (pt.u, pj.u)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    for (a, b) in zip(pt.split(0.25, seed=2), pj.split(0.25, seed=2)):
        np.testing.assert_allclose(a.x_in, b.x_in, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(a.y, b.y, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(fit_rdrv(pt), jax_fit_rdrv(pj), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("method", ["histogram_median", "random_inverse_density",
                                    "pca_cuboid"])
def test_select_training_points_matches_jax(method):
    rng = np.random.default_rng(12)
    z = rng.normal(0.0, 1.5, (150, 3)) * np.array([2.0, 1.0, 0.5])
    y = z[:, 0]
    for n in (12, 30):
        got = td.select_training_points(z, y, n, method=method, seed=4)
        want = jd.select_training_points(z, y, n, method=method, seed=4)
        if method == "pca_cuboid":
            assert set(got.tolist()) == set(np.asarray(want).tolist())
        else:
            np.testing.assert_array_equal(got, want)


def _blobs(seed=21, per=40):
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0, 0.0, 0.0], [6.0, 1.0, -2.0], [-3.0, 7.0, 4.0]])
    return np.concatenate([c + rng.normal(0, 0.6, (per, 3)) for c in centers])


def _same_partition(a, b):
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(np.asarray(a).tolist())) == len(set(np.asarray(b).tolist()))


def test_kmeans_and_its_selection_match_sklearn_on_blobs():
    z = _blobs()
    km = tc.kmeans(z, 3, np.random.default_rng(0))
    from sklearn.cluster import KMeans

    sk = KMeans(n_clusters=3, random_state=0, n_init=4).fit(z)
    assert _same_partition(km.labels, sk.labels_)
    got = td.select_training_points(z, z[:, 0], 3, method="kmeans", seed=0)
    want = jd.select_training_points(z, z[:, 0], 3, method="kmeans", seed=0)
    np.testing.assert_array_equal(np.sort(got), np.sort(np.asarray(want)))


def test_gaussian_mixture_matches_the_jax_clustering_on_blobs():
    z = _blobs()
    x_in = np.zeros((len(z), 13))
    x_in[:, 7:10] = z
    dj = jd.ResidualDataset(x_in=x_in, u=np.zeros((len(z), 4)), y=np.zeros_like(x_in))
    dt_ = td.ResidualDataset(x_in=x_in, u=np.zeros((len(z), 4)), y=np.zeros_like(x_in))
    lab_j = dj.cluster(3, seed=0)
    lab_t = dt_.cluster(3, seed=0)
    assert _same_partition(lab_t, lab_j)
    perm = {int(a): int(b) for a, b in zip(lab_t, lab_j)}
    p_t = dt_._gmm.predict_proba(z)
    p_j = dj._gmm.predict_proba(z)
    np.testing.assert_allclose(p_t, p_j[:, [perm[c] for c in range(3)]], atol=1e-6)


def test_gaussian_mixture_cache_round_trip(tmp_path):
    z = _blobs()
    x_in = np.zeros((len(z), 13))
    x_in[:, 7:10] = z
    ds = td.ResidualDataset(x_in=x_in, u=np.zeros((len(z), 4)), y=np.zeros_like(x_in))
    path = str(tmp_path / "gmm.npz")
    first = ds.cluster(3, seed=0, cache_path=path).copy()
    ds2 = td.ResidualDataset(x_in=x_in, u=ds.u, y=ds.y)
    ds2._gmm = None
    np.testing.assert_array_equal(ds2.cluster(3, seed=5, cache_path=path), first)


class _Fixed:
    """A mixture stand-in whose memberships are given."""

    def __init__(self, probs):
        self.probs = probs

    def predict_proba(self, z):
        return self.probs


def test_cluster_agency_matches_jax_from_equal_responsibilities():
    rng = np.random.default_rng(9)
    probs = rng.dirichlet(np.ones(3), size=50)
    x_in = rng.normal(size=(50, 13))
    dj = jd.ResidualDataset(x_in=x_in, u=x_in[:, :4], y=x_in)
    dt_ = td.ResidualDataset(x_in=x_in, u=x_in[:, :4], y=x_in)
    dj._gmm, dt_._gmm = _Fixed(probs), _Fixed(probs)
    aj, at = dj.cluster_agency(), dt_.cluster_agency()
    assert aj.keys() == at.keys()
    for c in aj:
        np.testing.assert_array_equal(at[c], aj[c])


def test_fit_gp_ensemble_and_evaluation_match_jax():
    """One cluster, ``histogram_median`` selection: the same training
    points, hence the same fits."""
    rng = np.random.default_rng(14)
    m = 120
    x_in = np.zeros((m, 13))
    x_in[:, 7:10] = rng.uniform(-5, 5, (m, 3))
    y = np.zeros((m, 13))
    y[:, 7:10] = -0.1 * x_in[:, 7:10] * np.abs(x_in[:, 7:10]) + 0.05 * rng.normal(size=(m, 3))
    mk = lambda mod: mod.ResidualDataset(x_in=x_in, u=np.zeros((m, 4)), y=y)
    train_j, test_j = mk(jd).split(0.25, seed=0)
    train_t, test_t = mk(td).split(0.25, seed=0)
    ej = jf.fit_gp_ensemble(train_j, n_points=15, n_restarts=1, selection="histogram_median")
    et = tf.fit_gp_ensemble(train_t, n_points=15, n_restarts=1, selection="histogram_median")
    for name in ("x_train", "k_inv_y", "len_scale", "sigma_f", "sigma_n", "y_mean",
                 "centroids"):
        np.testing.assert_allclose(np.asarray(getattr(et, name)),
                                   np.asarray(getattr(ej, name)), rtol=1e-6, atol=1e-9,
                                   err_msg=name)
    mj, mt = jf.evaluate_ensemble(ej, test_j), tf.evaluate_ensemble(et, test_t)
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], rtol=1e-6, err_msg=k)
