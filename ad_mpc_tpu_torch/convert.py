"""Carry the JAX package's parameters across to the port, as numpy.

The port never imports the JAX package. These helpers take its objects by
their public shape alone (a NamedTuple's ``_asdict``, a dataclass's fields,
arrays or an npz file), so the tests can hand both packages the same
problem and the same warm start.

A fitted model is carried across once, as weights are: the JAX package
pickles its ensembles with JAX arrays inside, which a machine without JAX
cannot read, so :func:`save_gp_ensemble` writes one as a numpy ``.npz``
that ``learned.ensemble.load_npz`` reads. The fitted model of the c6-fitted
rows was written so, from the repository's root, on a machine with JAX:

    JAX_PLATFORMS=cpu python -c "from ad_mpc_tpu.utils.io import load_model; \
        from ad_mpc_tpu_torch.convert import save_gp_ensemble; \
        save_gp_ensemble(load_model('gp_flagship_c1'), \
                         'ad_mpc_tpu_torch/data/gp_flagship_c1.npz')"

The two-cluster candidate beside it (``gp_flagship_c2.npz``) was fitted on
a CPU by the JAX package's own steps (``experiments/gp_flagship.py:74-104``)
on the committed recording and written so:

    JAX_PLATFORMS=cpu python -c "from ad_mpc_tpu.utils import io; \
        from ad_mpc_tpu.learned.dataset import ResidualDataset; \
        from ad_mpc_tpu.learned.fitting import fit_gp_ensemble; \
        from ad_mpc_tpu_torch.convert import save_gp_ensemble; \
        a = io.load_arrays('results/experiments/gp_flagship/dataset'); \
        ds = ResidualDataset.from_rollouts(a['x_in'], a['u'], a['x_out'], \
                                           a['x_pred'], a['dt']); \
        train, _ = ds.prune(vel_cap=20.0, hist_thresh=1e-3, \
                            vel_idx=(7, 8, 9)).split(test_frac=0.2, seed=0); \
        save_gp_ensemble(fit_gp_ensemble(train, out_idx=(7, 8, 9), \
                                         feat_idx=(7, 8, 9), n_clusters=2, \
                                         n_points=60, n_restarts=3, seed=0), \
                         'ad_mpc_tpu_torch/data/gp_flagship_c2.npz')"
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ad_mpc_tpu_torch.learned.ensemble import GPEnsemble
from ad_mpc_tpu_torch.models.bicycle import BicycleParams
from ad_mpc_tpu_torch.models.pacejka import PacejkaParams
from ad_mpc_tpu_torch.models.quadrotor import QuadrotorParams
from ad_mpc_tpu_torch.ocp.solver import SolverState, load_iterate
from ad_mpc_tpu_torch.ocp.spec import OCPSpec


def bicycle_params(params) -> BicycleParams:
    """The port's :class:`BicycleParams` from the JAX package's."""
    return BicycleParams(**params._asdict())


def pacejka_params(params) -> PacejkaParams:
    """The port's :class:`PacejkaParams` from the JAX package's."""
    return PacejkaParams(**{k: float(v) for k, v in params._asdict().items()})


def gp_ensemble(ens) -> GPEnsemble:
    """The port's :class:`GPEnsemble` from the JAX package's: its arrays as
    float64 numpy (the port keeps them on the host), ``n_valid`` as int32,
    ``out_idx`` and ``feat_idx`` as they are."""
    f64 = lambda a: np.array(a, np.float64)
    return GPEnsemble(
        x_train=f64(ens.x_train), k_inv_y=f64(ens.k_inv_y),
        len_scale=f64(ens.len_scale), sigma_f=f64(ens.sigma_f),
        sigma_n=f64(ens.sigma_n), y_mean=f64(ens.y_mean),
        centroids=f64(ens.centroids),
        n_valid=np.asarray(ens.n_valid, np.int32),
        out_idx=tuple(int(i) for i in ens.out_idx),
        feat_idx=tuple(int(i) for i in ens.feat_idx))


def save_gp_ensemble(ens, path) -> None:
    """Write ``ens`` (the JAX package's or the port's) to the ``.npz``
    ``path``: every field of the port's :class:`GPEnsemble` as
    :func:`gp_ensemble` converts it, ``out_idx`` and ``feat_idx`` as
    integer arrays."""
    np.savez(path, **{k: np.asarray(v) for k, v in gp_ensemble(ens)._asdict().items()})


def quadrotor_params(params) -> QuadrotorParams:
    """The port's :class:`QuadrotorParams` from the JAX package's."""
    return QuadrotorParams(**params._asdict())


def ocp_spec(spec) -> OCPSpec:
    """The port's :class:`OCPSpec` from the JAX package's (same fields)."""
    return OCPSpec(**dataclasses.asdict(spec))


def quad_spec(spec) -> OCPSpec:
    """The port's :class:`OCPSpec` from the JAX package's ``quad_spec(...)``;
    refuses a spec of other dimensions than the quad's (13, 4)."""
    if (spec.nx, spec.nu) != (13, 4):
        raise ValueError(f"not a quad spec: nx={spec.nx}, nu={spec.nu}")
    return ocp_spec(spec)


def solver_state(xs=None, us=None, path=None, device="cuda") -> SolverState:
    """The port's :class:`SolverState` from (xs, us) arrays or from an npz
    written by either package's ``save_iterate``."""
    if path is not None:
        return load_iterate(path, device=device)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return SolverState(xs=as_t(xs), us=as_t(us))
