"""Port parity of the single-vehicle SQP solver (``ocp/solver.py:SQPSolver``)
and its per-stage integrators, against the JAX package on the CPU.

Float64 parity is held at ``tests/test_solver_core.py``'s 1e-9; the
float32 plain solver at the 1e-3 u0 bar; the oracle instance
(``tests/fixtures/oracle_bike_n20.npz``) at 1e-3 after 30 RTI re-solves,
as ``tests/test_acados_parity.py:test_rti_converges_to_oracle`` holds it.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ad_mpc_tpu.control.mpc import bicycle_spec as jax_bicycle_spec
from ad_mpc_tpu.models.bicycle import BicycleParams as JaxParams
from ad_mpc_tpu.models.bicycle import bicycle_dynamics as jax_dynamics
from ad_mpc_tpu.ocp.solver import SQPSolver as JaxSQPSolver
from ad_mpc_tpu.ops import integrators as jax_integrators
from ad_mpc_tpu_torch import convert
from ad_mpc_tpu_torch.models.bicycle import BicycleDynamics
from ad_mpc_tpu_torch.ocp.solver import SQPSolver, SolverState
from ad_mpc_tpu_torch.ops import integrators
from ad_mpc_tpu_torch.testing import bike_instance, rti_oracle_distance

N, DT = 10, 0.05


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain path's small operations run fastest on one thread, and the
    test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "oracle_bike_n20.npz")
# RTI, and full SQP with the merit line search (the point-reference mode's
# globalization at fewer iterations).
MODES = {"rti": dict(sqp_iters=1), "line_search": dict(sqp_iters=3, ls_steps=6)}


def _jax_dyn(x, u, p):
    return jax_dynamics(x, u, JaxParams(), switch=p[0])


def _spec(mode):
    return dataclasses.replace(
        jax_bicycle_spec(t_horizon=N * DT, n_nodes=N, qp_iters=10), **MODES[mode])


@pytest.fixture(scope="module")
def problem():
    """An arc with a lateral offset, the car perturbed off it; p broadcast
    (the blend switch, 0.3) or per stage (0 to 1 along the horizon)."""
    x0, yref, yref_u, _ = bike_instance(np.random.default_rng(5), N, DT)
    return {"x0": x0, "yref": yref, "yref_u": yref_u,
            "broadcast": np.array([0.3]),
            "per_stage": np.linspace(0.0, 1.0, N)[:, None]}


@pytest.fixture(scope="module")
def jax_runs(problem):
    """The JAX float64 solver's cold start and solve, per (mode, p)."""
    runs = {}
    for mode in MODES:
        solver = JaxSQPSolver(_spec(mode), _jax_dyn, p_dim=1, dtype=jnp.float64)
        st = solver.init_state(jnp.asarray(problem["x0"]))
        for kind in ("broadcast", "per_stage"):
            res = solver.solve(*(jnp.asarray(problem[k]) for k in
                                 ("x0", "yref", "yref_u", kind)), st)
            runs[mode, kind] = (st, res, solver.shift(res.state))
    return runs


def _port(mode, dtype=torch.float64):
    return SQPSolver(convert.ocp_spec(_spec(mode)), BicycleDynamics(), p_dim=1,
                     dtype=dtype, device="cpu")


def _state(st):
    """A JAX iterate as the port's, in float64 (``convert.solver_state``
    rounds to the fleet solver's float32)."""
    return SolverState(*(torch.tensor(np.asarray(a)) for a in (st.xs, st.us)))


def _args(problem, kind, dtype=torch.float64):
    return [torch.as_tensor(problem[k], dtype=dtype)
            for k in ("x0", "yref", "yref_u", kind)]


@pytest.mark.parametrize("kind", ["broadcast", "per_stage"])
@pytest.mark.parametrize("mode", list(MODES))
def test_solver_matches_jax_float64(problem, jax_runs, mode, kind):
    st_j, res_j, _ = jax_runs[mode, kind]
    solver = _port(mode)
    x0, yref, yref_u, p = _args(problem, kind)
    res = solver.solve(x0, yref, yref_u, p, _state(st_j))
    np.testing.assert_allclose(res.us.numpy(), np.asarray(res_j.us), atol=1e-9)
    np.testing.assert_allclose(res.xs.numpy(), np.asarray(res_j.xs), atol=1e-9)
    np.testing.assert_allclose(float(res.kkt_residual),
                               float(res_j.kkt_residual), atol=1e-9)
    assert res.us.dtype == torch.float64


@pytest.mark.parametrize("mode", list(MODES))
def test_init_state_and_shift_match_jax(problem, jax_runs, mode):
    st_j, res_j, shifted_j = jax_runs[mode, "broadcast"]
    solver = _port(mode)
    st = solver.init_state(torch.as_tensor(problem["x0"]))
    np.testing.assert_allclose(st.xs.numpy(), np.asarray(st_j.xs), atol=1e-9)
    np.testing.assert_allclose(st.us.numpy(), np.asarray(st_j.us), atol=1e-9)
    shifted = solver.shift(_state(res_j))
    np.testing.assert_array_equal(shifted.xs.numpy(), np.asarray(shifted_j.xs))
    np.testing.assert_array_equal(shifted.us.numpy(), np.asarray(shifted_j.us))


def test_rollout_p_and_linearize_p_match_jax():
    """The per-stage-parameter rollout and linearization (``ops/integrators.py:
    54-78``) on a random iterate with the blend switch varying by stage."""
    rng = np.random.default_rng(6)
    xs = rng.normal(0.0, 0.4, (N + 1, 7))
    xs[:, 3] += 8.0
    us = rng.normal(0.0, 0.5, (N, 2))
    ps = rng.uniform(0.0, 1.0, (N, 1))
    Fj = lambda x, u, p: jax_integrators.discretize(
        lambda xx, uu: _jax_dyn(xx, uu, p), DT)(x, u)
    dyn = BicycleDynamics()
    Ft = lambda x, u, p: integrators.discretize(
        lambda xx, uu: dyn(xx, uu, p), DT)(x, u)
    t = lambda a: torch.as_tensor(a)
    np.testing.assert_allclose(
        integrators.rollout_p(Ft, t(xs[0]), t(us), t(ps)).numpy(),
        np.asarray(jax_integrators.rollout_p(Fj, *map(jnp.asarray, (xs[0], us, ps)))),
        atol=1e-9)
    got = integrators.linearize_p(Ft, t(xs), t(us), t(ps))
    want = jax_integrators.linearize_p(Fj, *map(jnp.asarray, (xs, us, ps)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-9)


@pytest.mark.parametrize("mode", list(MODES))
def test_float32_plain_solver_u0(problem, jax_runs, mode):
    """The deployed dtype: the float32 plain solver from the same warm start
    lands within the 1e-3 bar of the float64 JAX solve."""
    st_j, res_j, _ = jax_runs[mode, "broadcast"]
    solver = _port(mode, torch.float32)
    res = solver.solve(*_args(problem, "broadcast", torch.float32), _state(st_j))
    assert res.us.dtype == torch.float32
    assert float(np.abs(res.us[0].double().numpy()
                        - np.asarray(res_j.us[0])).max()) < 1e-3


def test_rti_converges_to_oracle_on_the_plain_backend():
    """30 float32 RTI re-solves without shift on the committed oracle
    instance end within 1e-3 of the oracle's u0; the plain backend launches
    nothing."""
    d, launches = rti_oracle_distance(FIXTURE, "cpu")
    assert d < 1e-3, d
    assert launches == {"vde": 0, "lq_ipm": 0, "rk4": 0}


def test_backends_refuse_what_they_cannot_run():
    spec = convert.ocp_spec(_spec("rti"))
    dyn = BicycleDynamics()
    with pytest.raises(ValueError, match="float32"):
        SQPSolver(spec, dyn, p_dim=1, dtype=torch.float64, device="cuda",
                  backend="cuda")
    with pytest.raises(ValueError, match="not a CUDA device"):
        SQPSolver(spec, dyn, p_dim=1, device="cpu", backend="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SQPSolver(spec, dyn, p_dim=1)  # the card by default
