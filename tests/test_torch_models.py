"""Port parity: bicycle model, bicycle spec, yaw wrap and the converters.

The same float32 numpy inputs go through ``ad_mpc_tpu`` (JAX, CPU) and
``ad_mpc_tpu_torch`` (PyTorch, CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ad_mpc_tpu.control.mpc import bicycle_spec as jax_bicycle_spec
from ad_mpc_tpu.models.bicycle import BicycleParams as JaxParams
from ad_mpc_tpu.models.bicycle import bicycle_dynamics as jax_dynamics
from ad_mpc_tpu.utils.math import yaw_wrap_reference as jax_yaw_wrap
from ad_mpc_tpu_torch import convert
from ad_mpc_tpu_torch.control.mpc import bicycle_spec
from ad_mpc_tpu_torch.models.bicycle import BicycleDynamics, bicycle_dynamics
from ad_mpc_tpu_torch.utils.math import yaw_wrap_reference


def _draw(rng, shape):
    x = rng.normal(0.0, 0.4, (7,) + shape).astype(np.float32)
    x[3] += 8.0
    u = rng.normal(0.0, 0.5, (2,) + shape).astype(np.float32)
    return x, u


@pytest.mark.parametrize("shape", [(), (6, 5)], ids=["vector", "slab"])
@pytest.mark.parametrize("switch", [1.0, 0.3, 0.0])
def test_bicycle_dynamics_matches_jax(switch, shape):
    x, u = _draw(np.random.default_rng(0), shape)
    s = np.float32(switch)
    want = np.asarray(jax_dynamics(jnp.asarray(x), jnp.asarray(u),
                                   JaxParams(), switch=s))
    got = bicycle_dynamics(torch.as_tensor(x), torch.as_tensor(u),
                           convert.bicycle_params(JaxParams()),
                           switch=torch.tensor(s))
    assert got.shape == (7,) + shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_bicycle_module_reads_switch_from_p():
    x, u = _draw(np.random.default_rng(1), (4,))
    p = np.full((1, 4), 0.3, np.float32)
    got = BicycleDynamics()(torch.as_tensor(x), torch.as_tensor(u),
                            torch.as_tensor(p))
    want = jax_dynamics(jnp.asarray(x), jnp.asarray(u), JaxParams(),
                        switch=jnp.asarray(p[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_bicycle_spec_arrays_match_jax():
    ours = bicycle_spec(t_horizon=1.5, n_nodes=30, qp_iters=12)
    ref = jax_bicycle_spec(t_horizon=1.5, n_nodes=30, qp_iters=12)
    for a, b in zip(ours.weight_arrays(), ref.weight_arrays()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.bound_arrays(), ref.bound_arrays()):
        np.testing.assert_array_equal(a, b)
    assert convert.ocp_spec(ref) == ours


def test_yaw_wrap_matches_jax():
    rng = np.random.default_rng(2)
    psi_ref = rng.uniform(-7.0, 7.0, (6, 11)).astype(np.float32)
    psi0 = rng.uniform(-3.1, 3.1, 6).astype(np.float32)
    want = np.stack([np.asarray(jax_yaw_wrap(jnp.asarray(r), jnp.asarray(p)))
                     for r, p in zip(psi_ref, psi0)])
    got = yaw_wrap_reference(torch.as_tensor(psi_ref),
                             torch.as_tensor(psi0)[:, None])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
