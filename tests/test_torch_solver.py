"""Port parity for the slice as a whole: batched SQP-RTI solve, the c2
fleet tick and the warm-start file format.

Both packages solve the same problem from the same warm start, which
``ad_mpc_tpu_torch.convert`` carries across as numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from ad_mpc_tpu.control.mpc import bicycle_spec as jax_bicycle_spec
from ad_mpc_tpu.models.bicycle import BicycleParams as JaxParams
from ad_mpc_tpu.models.bicycle import bicycle_dynamics as jax_dynamics
from ad_mpc_tpu.ocp.solver import BatchedSQPSolver as JaxBatchedSQPSolver
from ad_mpc_tpu.ocp.solver import SolverState as JaxSolverState
from ad_mpc_tpu.ocp.solver import save_iterate as jax_save_iterate
from ad_mpc_tpu_torch import convert, fleet
from ad_mpc_tpu_torch.models.bicycle import BicycleDynamics
from ad_mpc_tpu_torch.ocp.solver import BatchedSQPSolver, save_iterate

N = 10


def _problem(B, seed=0):
    """A curving reference and a perturbed warm start, float32 numpy."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(5.0, 12.0, B).astype(np.float32)
    x0 = np.zeros((B, 7), np.float32)
    x0[:, 3] = v
    x0[:, 1] = rng.uniform(-0.5, 0.5, B)
    t = np.arange(N + 1, dtype=np.float32) * 0.05
    yref = np.zeros((B, N + 1, 7), np.float32)
    yref[:, :, 0] = v[:, None] * t
    yref[:, :, 1] = rng.uniform(-1.0, 1.0, B)[:, None]
    yref[:, :, 2] = rng.uniform(-3.0, 3.0, B)[:, None]  # exercises yaw wrap
    yref[:, :, 3] = v[:, None]
    yref_u = np.zeros((B, N, 2), np.float32)
    p = np.ones((B, 1), np.float32)
    xs = np.repeat(x0[:, None], N + 1, axis=1)
    xs += rng.normal(0.0, 0.02, xs.shape).astype(np.float32)
    us = rng.normal(0.0, 0.1, (B, N, 2)).astype(np.float32)
    return x0, yref, yref_u, p, xs, us


def test_batched_solver_matches_jax():
    spec_j = jax_bicycle_spec(t_horizon=0.5, n_nodes=N, qp_iters=10)
    x0, yref, yref_u, p, xs, us = _problem(B=4)

    dyn_j = lambda x, u, pp: jax_dynamics(x, u, JaxParams(), switch=pp[0])
    ref = JaxBatchedSQPSolver(spec_j, dyn_j, p_dim=1, backend="xla").solve(
        *(jnp.asarray(a) for a in (x0, yref, yref_u, p)),
        JaxSolverState(jnp.asarray(xs), jnp.asarray(us)))

    solver = BatchedSQPSolver(convert.ocp_spec(spec_j),
                              BicycleDynamics(convert.bicycle_params(JaxParams())),
                              p_dim=1, device="cpu")
    res = solver.solve(*(torch.as_tensor(a) for a in (x0, yref, yref_u, p)),
                       convert.solver_state(xs, us, device="cpu"))

    np.testing.assert_allclose(res.us[:, 0].numpy(), np.asarray(ref.us[:, 0]),
                               atol=1e-4)
    np.testing.assert_allclose(res.xs.numpy(), np.asarray(ref.xs), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(res.kkt_residual.numpy(),
                               np.asarray(ref.kkt_residual), rtol=1e-2,
                               atol=1e-7)
    shifted = solver.shift(res.state)
    assert torch.equal(shifted.xs[:, -1], res.xs[:, -1])
    assert torch.equal(shifted.us[:, :-1], res.us[:, 1:])


def test_fleet_ticks_match_bench():
    B = 8
    tick_j, init_j, _, _ = bench.build_fleet(
        bench.dynamic_bicycle, lambda v, k, e: np.array([1.0], np.float32),
        n_nodes=N)
    tick, init, solver, _ = fleet.build_fleet(
        fleet.dynamic_bicycle, fleet.switch_on, n_nodes=N, device="cpu")
    carry_j, carry = init_j(B), init(B)
    for a, b in zip(carry_j[:5], carry[:5]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for _ in range(3):
        carry_j, (kkt_j, lat_j) = tick_j(carry_j)
        carry, (kkt, lat) = tick(carry)
        np.testing.assert_allclose(carry[0].numpy(), np.asarray(carry_j[0]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(lat), float(lat_j), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(kkt.numpy(), np.asarray(kkt_j), rtol=1e-2,
                                   atol=1e-7)
    assert solver.vde.launches == 0 and solver.qp.launches == 0


def test_jax_iterate_loads_into_port(tmp_path):
    _, _, _, _, xs, us = _problem(B=3, seed=4)
    path = jax_save_iterate(str(tmp_path / "it.npz"),
                            JaxSolverState(jnp.asarray(xs), jnp.asarray(us)))
    st = convert.solver_state(path=path, device="cpu")
    np.testing.assert_array_equal(st.xs.numpy(), xs)
    np.testing.assert_array_equal(st.us.numpy(), us)
    again = convert.solver_state(
        path=save_iterate(str(tmp_path / "back.npz"), st), device="cpu")
    assert torch.equal(again.xs, st.xs) and torch.equal(again.us, st.us)


@pytest.mark.parametrize("seed", [0, 1])
def test_scenarios_and_references_match_bench(seed):
    v, kappa = fleet.make_scenarios(16, seed)
    vj, kj = bench.make_scenarios(16, seed)
    np.testing.assert_array_equal(v, np.asarray(vj))
    np.testing.assert_array_equal(kappa, np.asarray(kj))
    kappa[:2] = 0.0  # the straight-line branch
    s0 = np.linspace(0.0, 30.0, 16).astype(np.float32)
    ref = fleet.arc_reference(*(torch.as_tensor(a) for a in (v, kappa, s0)),
                              N, 0.05, 2.7)
    for b in range(16):
        want = bench.arc_reference(jnp.float32(v[b]), jnp.float32(kappa[b]),
                                   jnp.float32(s0[b]), N, 0.05, 2.7)
        got, want = ref[b].numpy(), np.asarray(want)
        np.testing.assert_allclose(np.delete(got, 1, axis=1),
                                   np.delete(want, 1, axis=1),
                                   rtol=1e-6, atol=1e-5)
        # y = (1 - cos(psi)) / kappa: four f32 ulps of cos near 1, over kappa.
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0,
                                   atol=2.4e-7 / max(abs(kappa[b]), 1e-6))
