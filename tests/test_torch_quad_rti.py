"""The c5 fleet's RTI-vs-converged gate in both packages, on the same
fleet state: the port's carry after three plain ticks at B=8 (two
Gauss-Newton iterations) is handed to the port's and to the JAX
package's ``rti_vs_converged_quad``, whose answers agree within 5% (the
JAX side compiles its two solvers, the slow part, in a file of its own so
that the test workers spread the load)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ad_mpc_tpu.experiments import quad_fleet as jax_quad_fleet
from ad_mpc_tpu.ocp.solver import SolverState as JaxSolverState
from ad_mpc_tpu_torch.experiments import quad_fleet
from ad_mpc_tpu_torch.testing import one_thread  # noqa: F401 (autouse)


def jax_carry(carry):
    """The port's fleet carry as the JAX package's."""
    *arrays, states = carry
    return (*(jnp.asarray(a.numpy()) for a in arrays),
            JaxSolverState(jnp.asarray(states.xs.numpy()), jnp.asarray(states.us.numpy())))


@pytest.fixture(scope="module")
def last_carry():
    tick, init, _, _ = quad_fleet.build_quad_fleet(device="cpu")
    carry = init(8)
    for _ in range(3):
        carry, _ = tick(carry)
    return carry


def test_rti_vs_converged_quad_matches_jax(last_carry):
    got = quad_fleet.rti_vs_converged_quad(last_carry, n_check=4)
    want = jax_quad_fleet.rti_vs_converged_quad(jax_carry(last_carry), n_check=4,
                                                deployed_sqp_iters=2)
    assert got <= quad_fleet.RTI_GATE
    np.testing.assert_allclose(got, want, rtol=0.05, atol=2e-6)
