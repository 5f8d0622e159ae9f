"""Port parity for ``ocp/propagation.py``: the mean and covariance rollout
(with process noise, and with a learned residual's variance injected)
against the JAX package in float64 at 1e-9, the input reshape, and the
plant rollout's shape and determinism."""

import jax.numpy as jnp
import numpy as np
import torch

from ad_mpc_tpu.models.quadrotor import quad_dynamics as jax_quad
from ad_mpc_tpu.ocp import propagation as jp
from ad_mpc_tpu_torch.models.quadrotor import hover_input, quad_dynamics
from ad_mpc_tpu_torch.ocp import propagation as tp
from ad_mpc_tpu_torch.sim.simulator import DisturbanceConfig, QuadrotorSim
from ad_mpc_tpu_torch.testing import one_thread  # noqa: F401 (autouse)


def _start():
    rng = np.random.default_rng(3)
    x0 = np.zeros(13)
    x0[2], x0[3] = 1.0, 1.0
    x0[7:10] = rng.normal(0, 1.0, 3)
    x0[10:13] = rng.normal(0, 0.2, 3)
    us = hover_input()[None] + rng.uniform(-0.05, 0.05, (4, 4))
    return x0, us


def _var_t(x, u):
    return x[7:10] ** 2 + 0.1 * u[:3]


def _var_j(x, u):
    return x[7:10] ** 2 + 0.1 * u[:3]


def test_forward_prop_matches_jax():
    x0, us = _start()
    P0 = 1e-3 * np.eye(13)
    W = 1e-4 * np.diag(np.arange(1, 14))
    Bx = np.zeros((13, 3))
    Bx[7:10] = np.eye(3)
    for kw_t, kw_j in (({}, {}),
                       ({"residual_var_fn": _var_t, "residual_select": Bx},
                        {"residual_var_fn": _var_j, "residual_select": jnp.asarray(Bx)})):
        xs, Ps = tp.forward_prop(lambda x, u: quad_dynamics(x, u), torch.as_tensor(x0),
                                 torch.as_tensor(us), 0.05, P0=torch.as_tensor(P0),
                                 process_noise=torch.as_tensor(W), **kw_t)
        xs_j, Ps_j = jp.forward_prop(lambda x, u: jax_quad(x, u), jnp.asarray(x0),
                                     jnp.asarray(us), 0.05, P0=jnp.asarray(P0),
                                     process_noise=jnp.asarray(W), **kw_j)
        np.testing.assert_allclose(xs.numpy(), np.asarray(xs_j), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(Ps.numpy(), np.asarray(Ps_j), rtol=1e-9, atol=1e-9)
    assert float(Ps[1, 7, 7]) > float(tp.forward_prop(
        lambda x, u: quad_dynamics(x, u), torch.as_tensor(x0), torch.as_tensor(us), 0.05,
        P0=torch.as_tensor(P0), process_noise=torch.as_tensor(W))[1][1, 7, 7])


def test_reshape_input_sequence_matches_jax():
    u = np.arange(12.0)
    np.testing.assert_array_equal(tp.reshape_input_sequence(torch.as_tensor(u), 4).numpy(),
                                  np.asarray(jp.reshape_input_sequence(jnp.asarray(u), 4)))


def test_simulate_plant_shapes_and_determinism():
    x0, us = _start()
    sim = QuadrotorSim(disturbances=DisturbanceConfig(noisy=True))
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(0)
        runs.append(tp.simulate_plant(sim, torch.as_tensor(x0), torch.as_tensor(us[:4]),
                                      0.02, generator=gen))
    assert runs[0].shape == (5, 13)
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    torch.testing.assert_close(runs[0][0], torch.as_tensor(x0))
