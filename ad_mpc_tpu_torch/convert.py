"""Carry the JAX package's parameters across to the port, as numpy.

The port never imports the JAX package. These helpers take its objects by
their public shape alone (a NamedTuple's ``_asdict``, a dataclass's fields,
arrays or an npz file), so the tests can hand both packages the same
problem and the same warm start.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ad_mpc_tpu_torch.models.bicycle import BicycleParams
from ad_mpc_tpu_torch.models.quadrotor import QuadrotorParams
from ad_mpc_tpu_torch.ocp.solver import SolverState, load_iterate
from ad_mpc_tpu_torch.ocp.spec import OCPSpec


def bicycle_params(params) -> BicycleParams:
    """The port's :class:`BicycleParams` from the JAX package's."""
    return BicycleParams(**params._asdict())


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
