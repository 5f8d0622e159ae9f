"""Port parity for the parameter-routed GP (``ad_mpc_tpu/learned/
lane.py:151-253``): the cluster gather, the mean read from parameter rows,
both forms of the routed dynamics and their linearization, the fleet's
batched packer, and the routed fleet solver against the baked GP quad.

Inputs are drawn from a seed with numpy; the JAX side runs on the CPU.
Tolerances: the dynamics 1e-5 (``tests/test_pallas_vde.py:298``, with its
construction), the linearization 2e-5, the gather equal, and the routed
solver with a one-cluster ensemble 1e-6 on u0 against ``GPQuadDynamics``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ad_mpc_tpu.experiments import quad_fleet as jqf
from ad_mpc_tpu.learned import lane as jl
from ad_mpc_tpu.learned.ensemble import GPEnsemble as JaxEnsemble
from ad_mpc_tpu.models.bicycle import BicycleParams as JaxBicycleParams
from ad_mpc_tpu.models.bicycle import bicycle_dynamics as jax_bicycle
from ad_mpc_tpu.models.quadrotor import quad_dynamics_lane as jax_quad_lane
from ad_mpc_tpu.ops.integrators import discretize, linearize
from ad_mpc_tpu_torch.experiments import quad_fleet
from ad_mpc_tpu_torch.experiments.routed_fleet import (
    LAUNCHES_PER_TICK, body_velocities, build_routed_quad_fleet)
from ad_mpc_tpu_torch.learned import lane as tl
from ad_mpc_tpu_torch.models import gp_routed
from ad_mpc_tpu_torch.models.bicycle import BicycleDynamics
from ad_mpc_tpu_torch.models.quadrotor import QuadDynamics
from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4, make_vde
from ad_mpc_tpu_torch.testing import quad_traj, routed_bicycle_ensemble
from ad_mpc_tpu_torch.testing import one_thread  # noqa: F401 (autouse)


def _jax_ens(ens):
    return JaxEnsemble(*(jnp.asarray(getattr(ens, k)) if k not in ("out_idx", "feat_idx")
                         else getattr(ens, k) for k in JaxEnsemble._fields))


def _jax_bicycle(x, u, p):
    return jax_bicycle(x, u, JaxBicycleParams(), switch=p[0])


def test_param_routed_bicycle_matches_jax():
    """``test_param_routed_clusters_match_fixed_gather``'s construction: each
    cluster's basin, the port's routed dynamics against the JAX package's
    at 1e-5, and the gathered rows equal."""
    ens = routed_bicycle_ensemble()
    ej = _jax_ens(ens)
    dyn, p_dim, pack = tl.param_residual_dynamics(ens, BicycleDynamics(), 1)
    f_j, p_dim_j, pack_j = jl.param_residual_dynamics(ej, _jax_bicycle, 1)
    assert isinstance(dyn, gp_routed.GPRoutedDynamics) and p_dim == p_dim_j == 73
    assert tl.gp_param_dim(ens) == jl.gp_param_dim(ej) == 72
    rng = np.random.default_rng(4)
    for c in range(2):
        x = rng.normal(0, 0.3, 7).astype(np.float32)
        x[3:7] += 3.0 * c
        u = rng.normal(0, 0.2, 2).astype(np.float32)
        z = x[3:7].astype(np.float64)
        p = pack(torch.as_tensor(z), torch.ones(1))
        p_j = pack_j(jnp.asarray(z), jnp.ones(1, jnp.float32))
        np.testing.assert_array_equal(p.numpy(), np.asarray(p_j))
        got = dyn(torch.as_tensor(x), torch.as_tensor(u), p)
        want = f_j(jnp.asarray(x), jnp.asarray(u), p_j)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0,
                                   err_msg=f"cluster {c}")


def _quad_two_clusters():
    ens = quad_fleet.make_quad_gp_ensemble(n=8, clusters=2)
    return ens, _jax_ens(ens)


def test_param_routed_quad_frame_matches_jax():
    ens, ej = _quad_two_clusters()
    dyn, p_dim, pack = tl.param_residual_dynamics(ens, QuadDynamics(), 0, quad_frame=True)
    f_j, p_dim_j, pack_j = jl.param_residual_dynamics(
        ej, lambda x, u, p: jax_quad_lane(x, u, p), 0, quad_frame=True)
    assert isinstance(dyn, gp_routed.GPQuadRoutedDynamics) and p_dim == p_dim_j == 111
    xs, us = quad_traj(np.random.default_rng(6), 6, 1)
    xs[:, :, 7:10] *= 8.0
    for x, u in zip(xs[:, 0], us[:, 0]):
        z = body_velocities(torch.as_tensor(x, dtype=torch.float64)[None])[0]
        p = pack(z)
        p_j = pack_j(jnp.asarray(z.numpy()))
        np.testing.assert_array_equal(p.numpy(), np.asarray(p_j))
        got = dyn(torch.as_tensor(x), torch.as_tensor(u), p)
        want = f_j(jnp.asarray(x), jnp.asarray(u), p_j)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_param_gp_mean_matches_jax():
    ens, ej = _quad_two_clusters()
    per = 8 * 3 + 8 + 3 + 2
    rng = np.random.default_rng(9)
    z = rng.normal(0, 3, (3, 5))
    p = np.asarray(jl.gather_cluster_params(ej, jnp.asarray(z[:, 0])), np.float64)
    ps = np.repeat(p[:, None], 5, axis=1)
    for k in range(3):
        got = tl.param_gp_mean(8, 3, torch.as_tensor(ps), k * per,
                               [torch.as_tensor(r) for r in z])
        want = jl.param_gp_mean(8, 3, jnp.asarray(ps), k * per, [jnp.asarray(r) for r in z])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_pack_on_the_fleet_matches_jax_gather():
    """The batched packer's rows equal the JAX gather scenario by scenario,
    with both clusters present."""
    ens, ej = _quad_two_clusters()
    pack = tl.ClusterPacker(ens)
    z = np.random.default_rng(10).normal(2.0, 3.0, (40, 3))
    got = pack(torch.as_tensor(z)).numpy()
    assert len(set(pack.clusters(torch.as_tensor(z)).flatten().tolist())) == 2
    want = np.stack([np.asarray(jl.gather_cluster_params(ej, jnp.asarray(zz))) for zz in z])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", ["bicycle", "quad_frame"])
def test_routed_linearization_matches_jax(form):
    """The plain sweep (A, Bm, c) and RK4 defect of both forms against the
    JAX package's ``linearize`` of the same dynamics at 2e-5, both in
    float64 (the bicycle's 1 / v_x amplifies float32 rounding past it)."""
    rng = np.random.default_rng(11)
    B, N, dt = 4, 3, 0.1
    if form == "bicycle":
        ens = routed_bicycle_ensemble()
        ej = _jax_ens(ens)
        dyn, p_dim, pack = tl.param_residual_dynamics(ens, BicycleDynamics(), 1)
        f_j, _, _ = jl.param_residual_dynamics(ej, _jax_bicycle, 1)
        xs = rng.normal(0.0, 0.3, (B, N + 1, 7)).astype(np.float32)
        xs[:B // 2, :, 3] += 1.0  # v_x away from 0, nearest cluster 0
        xs[B // 2:, :, 3:7] += 3.0
        us = rng.normal(0.0, 0.2, (B, N, 2)).astype(np.float32)
        z = torch.as_tensor(xs[:, 0, 3:7], dtype=torch.float64)
        ps = pack(z, torch.ones(1))
        nx, nu = 7, 2
    else:
        ens, ej = _quad_two_clusters()
        dyn, p_dim, pack = tl.param_residual_dynamics(ens, QuadDynamics(), 0,
                                                      quad_frame=True)
        f_j, _, _ = jl.param_residual_dynamics(
            ej, lambda x, u, p: jax_quad_lane(x, u, p), 0, quad_frame=True)
        xs, us = quad_traj(rng, B, N)
        xs[B // 2:, :, 7:10] += 6.0  # body velocities near cluster 1
        z = body_velocities(torch.as_tensor(xs[:, 0], dtype=torch.float64))
        ps = pack(z)
        nx, nu = 13, 4
    xs, us = xs.astype(np.float64), us.astype(np.float64)
    xt, ut, ps = torch.as_tensor(xs), torch.as_tensor(us), ps.double()
    got = make_vde(dyn, dt, N, nx, nu, p_dim, device="cpu")(xt, ut, ps)
    defect = make_rk4(dyn, dt, nx, nu, p_dim, device="cpu").defect(xt, ut, ps)

    def one(x, u, p):
        return linearize(discretize(lambda a, b: f_j(a, b, p), dt, 1), x, u)

    want = jax.jit(jax.vmap(one))(jnp.asarray(xs), jnp.asarray(us),
                                  jnp.asarray(ps.numpy()))
    assert len(set(pack.clusters(z)[:, -1].tolist())) == 2
    for g, w in zip((*got, defect), (*want, want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0)


def test_routed_functor_params_and_refusals():
    ens, _ = _quad_two_clusters()
    dyn, p_dim, _ = tl.param_residual_dynamics(ens, QuadDynamics(), 0, quad_frame=True)
    s = dyn.cuda_params()
    assert (s.n, s.base_pd) == (8, 0) and p_dim == 3 * (4 * 8 + 5)
    assert (dyn.cuda_functor, dyn.cuda_source, dyn.cuda_entry, dyn.cuda_rk4_entry) == (
        "GPQuadRoutedDyn", "vde_gp_quad_routed", "vde_gp_quad_routed", "rk4_gp_quad_routed")
    big = quad_fleet.make_quad_gp_ensemble(n=65)
    with pytest.raises(ValueError, match="GPQuadRoutedDyn"):
        tl.param_residual_dynamics(big, QuadDynamics(), 0, quad_frame=True)[0].cuda_params()
    # Another base or layout has no functor: the plain backend only.
    plain, _, _ = tl.param_residual_dynamics(ens, QuadDynamics(), 0, quad_frame=False)
    assert plain.cuda_entry is None
    with pytest.raises(NotImplementedError):
        make_vde(plain, 0.1, 10, 13, 4, plain.p_dim, device="cuda")
    assert tl.gp_param_dim(quad_fleet.fitted_ensemble()) == 735
    assert tl.gp_param_dim(jqf.make_quad_gp_ensemble()) == 399


def test_routed_one_cluster_fleet_matches_gp_quad_fleet():
    """With one cluster the routed fleet is the c6 fleet: three plain ticks
    at B=6 agree on u0 within 1e-6, and nothing is launched."""
    ens = quad_fleet.make_quad_gp_ensemble(n=8)
    tick_r, init_r, solver_r, _, _ = build_routed_quad_fleet(ens, device="cpu")
    tick, init, _, _ = quad_fleet.build_quad_fleet(device="cpu", ensemble=ens)
    carry_r, carry = init_r(6), init(6)
    for _ in range(3):
        carry_r, (kkt_r, lat_r, p) = tick_r(carry_r)
        carry, (kkt, lat) = tick(carry)
        np.testing.assert_allclose(carry_r[5].us[:, 0].numpy(), carry[5].us[:, 0].numpy(),
                                   atol=1e-6, rtol=0)
    assert p.shape == (6, 3 * (4 * 8 + 5))
    assert solver_r.vde.launches == solver_r.qp.launches == solver_r.rk4.launches == 0
    assert LAUNCHES_PER_TICK == quad_fleet.LAUNCHES_PER_TICK


def test_routed_one_cluster_rk4_matches_gp_quad_rk4():
    """The fitted one-cluster model routed through p and baked into
    ``GPQuadDynamics``: their float32 RK4 maps (the plain versions here)
    on the c6-fitted fleet's states after a tick, each held to the float64
    plain version with its float32 spread, and to each other within
    ``testing.RK4_PAIR_TOL``."""
    from ad_mpc_tpu_torch.models.gp_quad import GPQuadDynamics
    from ad_mpc_tpu_torch.testing import RK4_PAIR_TOL, rk4_pair

    ens = quad_fleet.fitted_ensemble()
    tick, init, _, _ = quad_fleet.build_quad_fleet(device="cpu", ensemble=ens)
    carry, _ = tick(init(16))
    dyn, _, pack = tl.param_residual_dynamics(ens, QuadDynamics(), 0, quad_frame=True)
    x, u = carry[0], carry[5].us[:, 0]
    diff, err_r, err_b, spread, held = rk4_pair(
        dyn, pack(body_velocities(x)), GPQuadDynamics(ens), x.new_zeros((16, 0)), x, u, 0.1)
    assert held and diff <= RK4_PAIR_TOL, (diff, err_r, err_b, spread)
