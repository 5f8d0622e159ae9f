"""Port parity: Riccati recursion and the fused LQ-QP (kernel 2's plain
version).

The port's ``make_lq_solver(..., device="cpu")`` runs the plain batched IPM
that ``csrc/lq_ipm.cu`` is held against on the card. Here it is held against
the JAX package's Pallas kernel in both its stage-rolled and stage-unrolled
forms (interpret mode) and its vmapped ``qp_ipm.solve_lq_ocp``, at the
tolerance of ``tests/test_pallas_lq.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ad_mpc_tpu.ops.pallas_lq import _SideSpec
from ad_mpc_tpu.ops.pallas_lq import make_lq_solver as jax_make_lq_solver
from ad_mpc_tpu.ops.qp_ipm import BoundSpec as JaxBoundSpec
from ad_mpc_tpu.ops.qp_ipm import solve_lq_ocp as jax_solve_lq_ocp
from ad_mpc_tpu.ops.riccati import lqr_solve as jax_lqr_solve
from ad_mpc_tpu_torch import fleet
from ad_mpc_tpu_torch.ops import cuda_lq
from ad_mpc_tpu_torch.ops.cuda_lq import cone_entries, lq_geometry, make_lq_solver
from ad_mpc_tpu_torch.ops.riccati import lqr_solve
from ad_mpc_tpu_torch.testing import BOUNDS, LQ_WEIGHTS, random_lq

B, N, NX, NU, ITERS = 4, 10, 7, 2, 12


def _random_riccati(rng, batch, N, nx, nu):
    A = rng.normal(size=(batch, N, nx, nx)) * 0.4 + np.eye(nx) * 0.9
    Bm = rng.normal(size=(batch, N, nx, nu)) * 0.5
    c = rng.normal(size=(batch, N, nx)) * 0.1
    M = rng.normal(size=(batch, N + 1, nx, nx))
    Q = M @ np.swapaxes(M, -1, -2) * 0.1 + np.eye(nx)
    q = rng.normal(size=(batch, N + 1, nx))
    M = rng.normal(size=(batch, N, nu, nu))
    R = M @ np.swapaxes(M, -1, -2) * 0.1 + np.eye(nu)
    r = rng.normal(size=(batch, N, nu))
    dx0 = rng.normal(size=(batch, nx))
    return A, Bm, c, Q, q, R, r, dx0


def test_riccati_matches_jax_f64():
    args = _random_riccati(np.random.default_rng(1), 3, 6, 3, 2)
    dx, du = lqr_solve(*(torch.as_tensor(a) for a in args), reg=1e-8)
    ref = jax.vmap(lambda *a: jax_lqr_solve(*a, reg=1e-8))(
        *(jnp.asarray(a) for a in args))
    assert dx.dtype == torch.float64
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref[0]), atol=1e-9)
    np.testing.assert_allclose(du.numpy(), np.asarray(ref[1]), atol=1e-9)


def _jax_xla_solve(args, Q, R, QN, ub, xb, iters):
    A, Bm, c, q, r, u_ref, x_ref = (jnp.asarray(a) for a in args)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    Qs = jnp.concatenate([jnp.tile(f32(Q)[None], (N, 1, 1)), f32(QN)[None]])
    Rs = jnp.tile(f32(R)[None], (N, 1, 1))
    u_spec = JaxBoundSpec.make(f32(ub["lb"]), f32(ub["ub"]),
                               soft=jnp.asarray(ub["soft"]), zl=f32(ub["zl"]),
                               zu=f32(ub["zu"]), Zl=f32(ub["Zl"]),
                               Zu=f32(ub["Zu"]))
    x_spec = JaxBoundSpec.make(f32(xb["lb"]), f32(xb["ub"]),
                               soft=jnp.asarray(xb["soft"]))

    def one(A, Bm, c, q, r, u_ref, x_ref):
        dx, du, _ = jax_solve_lq_ocp(A, Bm, c, Qs, q, Rs, r,
                                     jnp.zeros(NX, jnp.float32), u_spec,
                                     x_spec, u_ref=u_ref, x_ref=x_ref,
                                     iters=iters)
        return dx, du

    with jax.default_matmul_precision("highest"):
        return jax.jit(jax.vmap(one))(A, Bm, c, q, r, u_ref, x_ref)


@pytest.mark.parametrize("reference", ["pallas_rolled", "pallas_unrolled",
                                       "xla"])
@pytest.mark.parametrize("bounds_kind", ["bicycle", "unit"])
def test_lq_matches_jax(bounds_kind, reference):
    args = random_lq(np.random.default_rng(5), B, N, NX, NU)
    Q, R = LQ_WEIGHTS
    QN = 1e-3 * Q
    ub, xb = BOUNDS[bounds_kind](NX, NU)

    solver = make_lq_solver(N, NX, NU, Q, R, QN, ub, xb, iters=ITERS,
                            device="cpu")
    dx, du, alpha = solver(*(torch.as_tensor(a) for a in args))
    assert dx.shape == (B, N + 1, NX) and du.shape == (B, N, NU)
    assert alpha.shape == (B,) and solver.launches == 0
    assert torch.all((alpha >= 0) & (alpha <= 1))

    if reference == "xla":
        ref = _jax_xla_solve(args, Q, R, QN, ub, xb, ITERS)
    else:
        ref = jax_make_lq_solver(
            N, NX, NU, Q, R, QN, ub, xb, iters=ITERS, interpret=True,
            block_b=8, roll_stages=reference == "pallas_rolled")(*args)
    np.testing.assert_allclose(du.numpy(), np.asarray(ref[1]), atol=3e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref[0]), atol=3e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("bounds_kind", ["bicycle", "unit"])
def test_cone_entries_match_pallas_sides(bounds_kind):
    """The bound list handed to the CUDA kernel holds the Pallas kernel's
    sides in its order: u_lo, u_hi, x_lo, x_hi, active entries ascending."""
    ub, xb = BOUNDS[bounds_kind](NX, NU)
    want = []
    for is_x, bd in ((0, ub), (1, xb)):
        for lo in (True, False):
            side = _SideSpec.make(**bd, lo=lo)
            want += [(is_x, j, int(lo), int(s), b, z, Z) for j, b, s, z, Z
                     in zip(side.idx, side.b, side.soft, side.z, side.Z)]
    assert cone_entries(ub, xb) == want


@pytest.mark.parametrize("nc", [0, 6, 18, 32])
@pytest.mark.parametrize("horizon", [10, 30, 40])
def test_lq_geometry_fits_a_block(horizon, nc):
    """Every horizon the port runs, with up to LQ_MAX_CONES bound entries,
    gets at least one scenario per block within the H100's 232,448 bytes,
    one team of 8 lanes per scenario, and a scenario region that starts on
    16 bytes and 8 mod 32 floats (the 4 teams of a warp on 4 bank offsets)."""
    geo = lq_geometry(horizon, NX, NU, nc)
    assert 1 <= geo.teams <= cuda_lq.MAX_TEAMS
    assert geo.threads == cuda_lq.team_lanes(NX) * geo.teams
    assert geo.block_bytes <= cuda_lq.SMEM_BLOCK_MAX
    assert geo.block_bytes == 4 * (cuda_lq.header_floats(NX, NU)
                                   + geo.teams * geo.pitch)
    assert geo.pitch % 32 == 8
    # the iterate, the step, the gains and the cone variables at least
    assert geo.pitch >= (2 * ((horizon + 1) * NX + horizon * NU)
                         + horizon * (NU * NX + NU) + 4 * nc * horizon)


def test_lq_geometry_fills_the_card_at_c2():
    """The c2 QP (N=30, 6 bound entries) runs 8 scenarios per block of 64
    threads: 128 blocks at B=1024, one on nearly every SM of 132."""
    _, _, solver, _ = fleet.build_fleet(fleet.dynamic_bicycle,
                                        fleet.switch_on, device="cpu")
    geo = solver.qp.geometry
    assert solver.qp._bounds.n == 6
    assert (geo.teams, geo.threads) == (8, 64)
    assert geo.blocks(1024) == 128 and geo.blocks(16384) == 2048


def test_lq_wrapper_allocates_no_scratch(monkeypatch):
    """The launch allocates the outputs and nothing else, and hands the
    kernel the geometry of :func:`lq_geometry`."""
    Q, R = LQ_WEIGHTS
    qp = make_lq_solver(N, NX, NU, Q, R, 1e-3 * Q, *BOUNDS["bicycle"](NX, NU),
                        iters=ITERS, device="cpu")
    args = [torch.as_tensor(a) for a in random_lq(np.random.default_rng(5),
                                                  B, N, NX, NU)]
    calls, sizes = [], []

    class FakeLib:
        def lq_ipm(self, *a):
            calls.append(a)
            return 0

    empty = torch.empty

    def counting_empty(*a, **k):
        t = empty(*a, **k)
        sizes.append(tuple(t.shape))
        return t

    monkeypatch.setattr(cuda_lq, "_lib", FakeLib)
    monkeypatch.setattr(torch, "empty", counting_empty)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    dx, du, alpha = qp._launch(*args)
    assert sizes == [(B, N + 1, NX), (B, N, NU), (B,)]
    assert len(calls) == 1 and qp.launches == 1
    geo = qp.geometry
    assert calls[0][-3:-1] == (geo.teams, geo.pitch)
