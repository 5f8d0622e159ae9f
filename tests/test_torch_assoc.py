"""Port parity for the associative-scan Riccati and the solver's backend
knob.

The scan follows ``jax.lax.associative_scan``'s recursion, so it repeats
JAX's float32 rounding bit for bit on an elementwise combine. The Riccati
comparisons are in float64 at the JAX package's own tolerance
(``tests/test_assoc_riccati.py:37-40``), at the function level: the port's
solver casts to float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ad_mpc_tpu.control.mpc import bicycle_spec as jax_bicycle_spec
from ad_mpc_tpu.experiments.long_horizon import random_lq as jax_random_lq
from ad_mpc_tpu.models.bicycle import BicycleParams as JaxParams
from ad_mpc_tpu.models.bicycle import bicycle_dynamics as jax_dynamics
from ad_mpc_tpu.ocp.solver import BatchedSQPSolver as JaxBatchedSQPSolver
from ad_mpc_tpu.ocp.solver import SolverState as JaxSolverState
from ad_mpc_tpu.ops.assoc_riccati import lqr_solve_assoc as jax_lqr_solve_assoc
from ad_mpc_tpu_torch import convert, fleet
from ad_mpc_tpu_torch.control.mpc import bicycle_spec
from ad_mpc_tpu_torch.experiments.long_horizon import random_lq
from ad_mpc_tpu_torch.models.bicycle import BicycleDynamics
from ad_mpc_tpu_torch.ocp.solver import BatchedSQPSolver, resolve_backend
from ad_mpc_tpu_torch.ops.assoc_riccati import associative_scan, lqr_solve_assoc
from ad_mpc_tpu_torch.ops.riccati import lqr_solve


def _random_lq(rng, N, nx, nu):
    """As ``tests/test_assoc_riccati.py:18-27``, float64 numpy."""
    A = np.eye(nx) + 0.05 * rng.normal(size=(N, nx, nx))
    B = 0.1 * rng.normal(size=(N, nx, nu))
    c = 0.01 * rng.normal(size=(N, nx))
    Q = np.stack([np.eye(nx) * u for u in rng.uniform(0.1, 2.0, N + 1)])
    q = rng.normal(size=(N + 1, nx))
    R = np.stack([np.eye(nu) * u for u in rng.uniform(0.5, 2.0, N)])
    r = 0.2 * rng.normal(size=(N, nu))
    dx0 = rng.normal(size=nx)
    return [A, B, c, Q, q, R, r, dx0]


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_repeats_jax_rounding(reverse):
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 5, 8, 13, 31, 64):
        x = (rng.normal(size=(3, n, 4))
             * 10.0 ** rng.integers(-6, 6, size=(3, n, 4))).astype(np.float32)
        want = np.asarray(jax.lax.associative_scan(
            jnp.add, jnp.asarray(x), reverse=reverse, axis=1))
        got = associative_scan(lambda a, b: (a[0] + b[0],), (torch.as_tensor(x),),
                               reverse=reverse, dim=1)[0]
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("N,nx,nu", [(1, 3, 2), (10, 7, 2), (64, 4, 1)])
def test_assoc_matches_jax_and_sequential(N, nx, nu, B):
    rng = np.random.default_rng(N * 10 + B)
    probs = [_random_lq(rng, N, nx, nu) for _ in range(B)]
    want = [jax_lqr_solve_assoc(*(jnp.asarray(a) for a in p), reg=1e-9)
            for p in probs]
    args = [torch.as_tensor(np.stack(z)) for z in zip(*probs)]
    dx, du = lqr_solve_assoc(*args, reg=1e-9)
    dx_s, du_s = lqr_solve(*args, reg=1e-9)
    for got, ref in ((dx, np.stack([np.asarray(w[0]) for w in want])),
                     (du, np.stack([np.asarray(w[1]) for w in want])),
                     (dx, dx_s.numpy()), (du, du_s.numpy())):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-10, rtol=1e-8)


def test_long_horizon_draws_match_jax():
    got = random_lq(np.random.default_rng(3), 12, device="cpu")
    want = jax_random_lq(np.random.default_rng(3), 12)
    for g, w in zip(got, want):
        assert g.shape == (1,) + w.shape and g.dtype == torch.float32
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_solver_plain_assoc_matches_jax():
    """A 3.2 s horizon (N=64) solve with the associative Riccati inside the
    IPM, port ``backend="plain"`` against JAX ``backend="xla"``."""
    N = 64
    spec_j = dataclasses.replace(
        jax_bicycle_spec(t_horizon=0.05 * N, n_nodes=N, qp_iters=10),
        assoc_riccati=True)
    v = np.array([9.0, 7.0], np.float32)
    x0 = np.zeros((2, 7), np.float32)
    x0[:, 3] = v
    t = np.arange(N + 1, dtype=np.float32) * 0.05
    yref = np.zeros((2, N + 1, 7), np.float32)
    yref[:, :, 0] = v[:, None] * t
    yref[:, :, 1] = np.array([1.5, -0.8], np.float32)[:, None]
    yref[:, :, 3] = v[:, None]
    yref_u = np.zeros((2, N, 2), np.float32)
    p = np.ones((2, 1), np.float32)
    xs = np.repeat(x0[:, None], N + 1, axis=1)
    us = np.zeros((2, N, 2), np.float32)

    dyn_j = lambda x, u, pp: jax_dynamics(x, u, JaxParams(), switch=pp[0])
    ref = JaxBatchedSQPSolver(spec_j, dyn_j, p_dim=1, backend="xla").solve(
        *(jnp.asarray(a) for a in (x0, yref, yref_u, p)),
        JaxSolverState(jnp.asarray(xs), jnp.asarray(us)))

    solver = BatchedSQPSolver(convert.ocp_spec(spec_j),
                              BicycleDynamics(convert.bicycle_params(JaxParams())),
                              p_dim=1, device="cpu", backend="plain")
    res = solver.solve(*(torch.as_tensor(a) for a in (x0, yref, yref_u, p)),
                       convert.solver_state(xs, us, device="cpu"))
    np.testing.assert_allclose(res.us.numpy(), np.asarray(ref.us), atol=1e-5)
    assert solver.vde.launches == 0 and solver.qp.launches == 0


def test_cuda_backend_refuses_assoc_riccati():
    spec = dataclasses.replace(bicycle_spec(t_horizon=0.5, n_nodes=10),
                               assoc_riccati=True)
    with pytest.raises(NotImplementedError, match="assoc_riccati"):
        BatchedSQPSolver(spec, fleet.dynamic_bicycle, p_dim=1, device="cuda",
                         backend="cuda")
    with pytest.raises(NotImplementedError, match="assoc_riccati"):
        BatchedSQPSolver(spec, fleet.dynamic_bicycle, p_dim=1, device="cpu",
                         backend="cuda")


def test_backend_resolution():
    assert resolve_backend("auto", "cpu") == "plain"
    assert resolve_backend("auto", "cuda") == "cuda"
    assert resolve_backend("auto", torch.device("cuda", 0)) == "cuda"
    assert resolve_backend("plain", "cuda") == "plain"
    with pytest.raises(ValueError):
        resolve_backend("xla", "cpu")
    spec = bicycle_spec(t_horizon=0.5, n_nodes=10)
    solver = BatchedSQPSolver(spec, fleet.dynamic_bicycle, p_dim=1, device="cpu")
    assert solver.backend == "plain"
    with pytest.raises(ValueError, match="not a CUDA device"):
        BatchedSQPSolver(spec, fleet.dynamic_bicycle, p_dim=1, device="cpu",
                         backend="cuda")


def test_fleet_backend_knob_on_cpu():
    """``build_fleet(backend="plain")`` on the CPU is the auto path."""
    runs = []
    for backend in ("auto", "plain"):
        tick, init, solver, _ = fleet.build_fleet(
            fleet.dynamic_bicycle, fleet.switch_on, n_nodes=6, device="cpu",
            backend=backend)
        carry = init(3)
        carry, _ = tick(carry)
        runs.append(carry[0])
        assert solver.backend == "plain"
    assert torch.equal(*runs)
