"""The team path of the quad sweeps (``csrc/vde.cuh:vde_team``; ``QuadDyn``
and ``GPQuadDyn``): its launch geometry, which the wrapper computes in
``ops/cuda_vde.py:vde_geometry`` and the C entry takes or refuses, and the
split of a row's tangent columns across a team's lanes.

On the CPU the geometry is checked as the kernel uses it
(``cuda_vde.lane_work``: each thread's row and columns): every row and every
one of its 17 columns is stored exactly once, for ragged batches and every
team width of the sweep (``experiments/quad_kernels.py``); every variant's
block fits an H100's shared memory and its launch bounds fit an SM. The
split itself is held to the JAX package: each lane's columns computed by
forward-mode JVPs of the port's plain RK4 map at its row, assembled by
``lane_work``, against the JAX package's Pallas sweep (interpret mode) on
the quad and its XLA linearization on the 8-point GP quad, at the 3e-5 of
``tests/test_pallas_vde.py``. The kernels themselves run on the card
(``tests/test_torch_gpu.py``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ad_mpc_tpu.experiments import quad_fleet as jqf
from ad_mpc_tpu.learned import lane as jl
from ad_mpc_tpu.models import quadrotor as jq
from ad_mpc_tpu.ops.integrators import discretize, linearize
from ad_mpc_tpu.ops.pallas_vde import make_vde as jax_make_vde
from ad_mpc_tpu_torch import convert
from ad_mpc_tpu_torch.experiments.quad_kernels import GP_QUAD_TEAMS, QUAD_TEAMS
from ad_mpc_tpu_torch.models.gp_quad import (
    GP_QUAD_DIMS, GP_QUAD_FEATS, GP_QUAD_POINTS, GPQuadDynamics)
from ad_mpc_tpu_torch.models.quadrotor import QuadDynamics
from ad_mpc_tpu_torch.ops._build import CSRC
from ad_mpc_tpu_torch.ops.cuda_lq import (
    MAX_BLOCKS_SM, SMEM_BLOCK_MAX, SMEM_BLOCK_RESERVED, SMEM_SM)
from ad_mpc_tpu_torch.ops.cuda_vde import (
    REGS_SM, THREADS_SM, WARP, lane_work, make_vde, vde_geometry)
from ad_mpc_tpu_torch.ops.integrators import discrete_step
from ad_mpc_tpu_torch.testing import quad_traj
from ad_mpc_tpu_torch.testing import one_thread  # noqa: F401 (autouse)

NX, NU, DT = 13, 4, 0.1
NV = NX + NU
# GPQuadDyn's static shared table: X and a, each dim padded by a float, 1/l
# and y_mean (csrc/vde_gp_quad.cu).
GP_QUAD_STATIC = 4 * GP_QUAD_DIMS * (GP_QUAD_POINTS * (GP_QUAD_FEATS + 1) + 2
                                     + GP_QUAD_FEATS + 1)
SOURCES = {"vde_quad": ("QUAD", QUAD_TEAMS, 0),
           "vde_gp_quad": ("GP_QUAD", GP_QUAD_TEAMS, GP_QUAD_STATIC)}
TEAMS = sorted({v[0] for vs in (QUAD_TEAMS, GP_QUAD_TEAMS) for v in vs})


def team_defaults(source):
    """{functor macro prefix: {"ROW_TEAM", "ROW_WARPS", "MIN_BLOCKS"}}: the
    team traits that ``csrc/<source>.cu`` is built with when no ``-D``
    overrides them."""
    out = {}
    for prefix, trait, n in re.findall(r"#define (\w+?)_(ROW_TEAM|ROW_WARPS|MIN_BLOCKS) (\d+)",
                                       (CSRC / f"{source}.cu").read_text()):
        out.setdefault(prefix, {})[trait] = int(n)
    return {p: v for p, v in out.items() if "ROW_TEAM" in v}


def resident_blocks(registers, threads, block_bytes):
    """Blocks of ``threads`` threads, ``registers`` each, and
    ``block_bytes`` of shared memory that one H100 SM holds at once
    (registers in units of 256 per warp)."""
    warps = -(-threads // WARP)
    per_warp = -(-registers * WARP // 256) * 256
    return min(MAX_BLOCKS_SM, THREADS_SM // threads, REGS_SM // (per_warp * warps),
               SMEM_SM // (block_bytes + SMEM_BLOCK_RESERVED))


def _coverage(geo, rows):
    """{(row, column): times stored}, and the rows whose c is stored, over
    every thread of every block of ``geo``."""
    stored, c_rows = {}, []
    for block in range(geo.grid):
        for thread in range(geo.threads):
            row, cols, writes_c, stores = lane_work(geo, rows, NV, block, thread)
            if not stores:
                continue
            for j in cols:
                stored[row, j] = stored.get((row, j), 0) + 1
            if writes_c:
                c_rows.append(row)
    return stored, c_rows


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("B,N", [(1, 10), (37, 10), (5, 3)])
def test_team_geometry_stores_each_row_and_column_once(team, B, N):
    """Ragged batches (B*N not a multiple of a block's rows): each of the
    B*N rows has each of its 17 columns and its c stored exactly once, and
    the last block's spare threads store nothing."""
    geo = vde_geometry(B, N, NX, NU, team, row_warps=4)
    rows = B * N
    stored, c_rows = _coverage(geo, rows)
    assert stored == {(r, j): 1 for r in range(rows) for j in range(NV)}
    assert sorted(c_rows) == list(range(rows))
    assert geo.grid * geo.rows_per_block >= rows > (geo.grid - 1) * geo.rows_per_block
    assert geo.cols == -(-NV // team)  # the fewest columns per lane


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_team_defaults_are_the_sweeps_first_variant(source):
    """The source's #defines (and vde.cuh's store) are the first
    (committed) variant of the sweep, so that its bits column compares
    every variant with them; the GP
    quad's team has a lane for each output dim."""
    prefix, variants, _ = SOURCES[source]
    d = team_defaults(source)[prefix]
    bulk = re.search(r"#define VDE_BULK_STORE (\d)", (CSRC / "vde.cuh").read_text())
    assert (d["ROW_TEAM"], d["ROW_WARPS"], d["MIN_BLOCKS"], int(bulk.group(1))) == \
        variants[0]
    if prefix == "GP_QUAD":
        assert all(v[0] >= GP_QUAD_DIMS for v in variants)


@pytest.mark.parametrize("source,variant", [
    (s, v) for s, (_, vs, _) in sorted(SOURCES.items()) for v in vs])
def test_team_variants_fit_the_card(source, variant):
    """Each variant's block (its tile and the GP quad's static table) fits a
    block's 232,448 bytes; its launch bounds agree with its block: the block
    is ROW_WARPS warps, MIN_BLOCKS such blocks fit an SM's threads, shared
    memory and registers at the capped count, and the cap leaves at least
    64 registers."""
    _, _, static = SOURCES[source]
    team, rw, min_blocks, _ = variant
    geo = vde_geometry(16384, 10, NX, NU, team, rw, min_blocks, static)
    assert geo.block_bytes == geo.shared_bytes + static <= SMEM_BLOCK_MAX
    assert geo.threads == 32 * rw and geo.rows_per_block * team == geo.threads
    assert geo.shared_bytes == 4 * geo.rows_per_block * NX * (NV + 1)
    assert 64 <= geo.max_registers <= 255
    assert resident_blocks(geo.max_registers, geo.threads, geo.block_bytes) >= min_blocks


def test_team_geometry_refuses_what_the_kernel_cannot_take():
    """A team that does not divide a warp, a block whose rows do not start
    on 16 bytes in c (13 floats a row), and launch bounds that no SM
    holds."""
    for team in (1, 3, 6):
        with pytest.raises(ValueError):
            vde_geometry(37, 10, NX, NU, team, 4)
    with pytest.raises(ValueError):
        vde_geometry(37, 10, NX, NU, 16, 1)  # 2 rows per block
    with pytest.raises(ValueError):
        vde_geometry(37, 10, NX, NU, 8, 4, min_blocks=17)  # 2,176 threads
    with pytest.raises(ValueError):
        vde_geometry(37, 10, NX, NU, 4, 8, min_blocks=4,
                     static_bytes=GP_QUAD_STATIC)  # 4 x 64 KB of shared memory


def test_resident_blocks_reckons_the_thread_per_row_sweeps():
    """The parent design's occupancy by its registers and tiles: the quad
    (255 registers, one warp of 29,952 B) 7 blocks per SM, the GP quad (2
    warps, two tiles and two 6,144 B means caches, the 3,072 B table) 3."""
    assert resident_blocks(255, 32, 29952) == 7
    assert resident_blocks(255, 64, 2 * (29952 + 6144) + 3072) == 3


def _team_sweep(dyn, geo, xs, us, ps):
    """The sweep as the team path computes and stores it, in plain PyTorch:
    each lane's columns by one forward-mode JVP of the RK4 map per column
    at its row, c by lane 0, placed by :func:`lane_work`; every entry
    written once."""
    B, N = us.shape[:2]
    rows = B * N
    x, u = xs[:, :-1].reshape(rows, NX), us.reshape(rows, NU)
    p = ps.repeat_interleave(N, 0)
    step = lambda a, b: discrete_step(dyn, DT, 1, a, b, p)
    seeds = torch.eye(NV, dtype=xs.dtype)
    cols = [torch.func.jvp(step, (x, u), (seeds[j, :NX].expand(rows, NX),
                                          seeds[j, NX:].expand(rows, NU)))[1]
            for j in range(NV)]
    c_all = step(x, u) - xs[:, 1:].reshape(rows, NX)
    A = torch.full((rows, NX, NX), float("nan"), dtype=xs.dtype)
    Bm = torch.full((rows, NX, NU), float("nan"), dtype=xs.dtype)
    c = torch.full((rows, NX), float("nan"), dtype=xs.dtype)
    for block in range(geo.grid):
        for thread in range(geo.threads):
            row, lane_cols, writes_c, stores = lane_work(geo, rows, NV, block, thread)
            if not stores:
                continue
            for j in lane_cols:
                if j < NX:
                    A[row, :, j] = cols[j][row]
                else:
                    Bm[row, :, j - NX] = cols[j][row]
            if writes_c:
                c[row] = c_all[row]
    return A.reshape(B, N, NX, NX), Bm.reshape(B, N, NX, NU), c.reshape(B, N, NX)


def _jax_quad(x, u, p):
    return jq.quad_dynamics_lane(x, u, p, jq.QuadrotorParams())


@pytest.fixture(scope="module")
def quad_case():
    """A ragged quad iterate (B=3, N=5) and the JAX package's Pallas sweep
    of it (interpret mode)."""
    B, N = 3, 5
    xs, us = quad_traj(np.random.default_rng(21), B, N)
    pallas = jax_make_vde(_jax_quad, DT, N, NX, NU, 0, block_b=8, interpret=True)
    want = pallas(jnp.asarray(xs), jnp.asarray(us), jnp.zeros((B, 1)))
    return xs, us, [np.asarray(w) for w in want]


@pytest.mark.parametrize("team", TEAMS)
def test_team_split_of_the_quad_sweep_matches_jax(quad_case, team):
    """Each team width's split of the quad's columns recovers the JAX
    package's sweep (A, Bm, c) at 3e-5."""
    xs, us, want = quad_case
    B, N = us.shape[:2]
    geo = vde_geometry(B, N, NX, NU, team, row_warps=4)
    got = _team_sweep(QuadDynamics(), geo, torch.as_tensor(xs), torch.as_tensor(us),
                      torch.zeros((B, 0)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=3e-5, rtol=0)


@pytest.mark.parametrize("team", [4, 8])
def test_team_split_of_the_gp_quad_sweep_matches_jax(team):
    """The GP quad (the 8-point synthetic ensemble, lane form): the team's
    split against the JAX package's XLA linearization and against the
    port's plain sweep (``vmap(jacfwd)``, whose batched GP sums may round
    otherwise), each at 3e-5."""
    ens_j = jqf.make_quad_gp_ensemble(n=8)
    dyn = GPQuadDynamics(convert.gp_ensemble(ens_j))
    B, N = 2, 3
    xs, us = quad_traj(np.random.default_rng(22), B, N)
    ps = np.zeros((B, 0), np.float32)

    def f_j(x, u, p):
        return jl.add_rows(_jax_quad(x, u, p), jl.quad_lane_residual_terms(ens_j, x))

    F = discretize(lambda xx, uu: f_j(xx, uu, None), DT, 1)
    want = jax.vmap(lambda a, b: linearize(F, a, b))(jnp.asarray(xs), jnp.asarray(us))
    args = [torch.as_tensor(a) for a in (xs, us, ps)]
    got = _team_sweep(dyn, vde_geometry(B, N, NX, NU, team, row_warps=4), *args)
    plain = make_vde(dyn, DT, N, NX, NU, 0, device="cpu")(*args)
    for g, w, q in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5, rtol=0)
        torch.testing.assert_close(g, q, atol=3e-5, rtol=0)
