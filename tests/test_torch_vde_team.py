"""The team path of the quad sweeps (``csrc/vde.cuh:vde_team``; ``QuadDyn``,
QuadMPC's RDRv ``QuadDragDyn``, ``GPQuadDyn``, QuadMPC's cluster-table GPs
``GPQuadDualDyn``, ``GPQuadDualDragDyn`` and ``GPQuadSelectDyn``, and the
routed ``GPQuadRoutedDyn``) and of the c4 Pacejka's and c3 GP bicycle's
(``PacejkaDyn``, ``GPBicycleDyn``): its launch geometry, which the wrapper
computes in ``ops/cuda_vde.py:vde_geometry`` and the C entry takes or
refuses, the cluster table or the scenarios' p rows that a block stages
after its tile, and the split of a row's tangent columns across a team's
lanes.

On the CPU the geometry is checked as the kernel uses it
(``cuda_vde.lane_work``: each thread's row and columns): every row and every
one of its 17 columns is stored exactly once, for ragged batches and every
team width of the sweep (``experiments/quad_kernels.py``); every variant's
block fits an H100's shared memory and its launch bounds fit an SM. The
split itself is held to the JAX package: each lane's columns computed by
forward-mode JVPs of the port's plain RK4 map at its row, assembled by
``lane_work``, against the JAX package's Pallas sweep (interpret mode) on
the quad and its XLA linearization on the 8-point GP quad, and, on a
two-cluster 8-point ensemble, the JAX package's QuadMPC ensemble dynamics
(its solver's discrete map, linearized) and ``quad_residual_fn`` plus the
quad, at the 3e-5 of ``tests/test_pallas_vde.py``; so are the drag's
split, against the Pallas sweep of the JAX package's ``quad_dynamics(
rdrv_d=D)``, and the routed GP's, on a two-cluster 8-point ensemble
against the JAX package's ``param_residual_dynamics(..., quad_frame=True)``
linearized by XLA. The bicycles' 9 columns (nx=7, nu=2) are split and
stored likewise for teams of 2, 4 and 8 lanes (``experiments/
bicycle_kernels.py``), and each width's split of the Pacejka (its 5-entry
p) and of the GP bicycle (a 6-point ensemble) is held to the JAX package's
XLA linearization at the 2e-5 of ``tests/test_pallas_vde.py``. The cluster
table's padding, the GP bicycle's table and the staged p rows' layout are
checked against the banks of shared memory that a warp's lanes read at
once. The kernels themselves run on the card (``tests/test_torch_gpu.py``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ad_mpc_tpu.control.mpc import QuadMPC as JaxQuadMPC
from ad_mpc_tpu.control.mpc import quad_spec as jax_quad_spec
from ad_mpc_tpu.experiments import quad_fleet as jqf
from ad_mpc_tpu.learned import ensemble as je
from ad_mpc_tpu.learned import lane as jl
from ad_mpc_tpu.models import pacejka as jp
from ad_mpc_tpu.models import quadrotor as jq
from ad_mpc_tpu.models.bicycle import BicycleParams, bicycle_dynamics
from ad_mpc_tpu.ops.integrators import discretize, linearize, linearize_p
from ad_mpc_tpu.ops.pallas_vde import make_vde as jax_make_vde
from ad_mpc_tpu_torch import convert, fleet
from ad_mpc_tpu_torch.experiments import quad_fleet
from ad_mpc_tpu_torch.experiments.bicycle_kernels import GP_BICYCLE_TEAMS, PACEJKA_TEAMS
from ad_mpc_tpu_torch.experiments.quad_kernels import (
    DRAG_TEAMS, GP_QUAD_TEAMS, QUAD_TEAMS, ROUTED_TEAMS, TABLE_TEAMS)
from ad_mpc_tpu_torch.models.gp_bicycle import GP_DIMS, GP_FEATS, GP_POINTS, gp_table_layout
from ad_mpc_tpu_torch.models.gp_quad import (
    GP_DUAL_CLUSTERS, GP_DUAL_POINTS, GP_DUAL_TABLE_MAX, GP_QUAD_DIMS, GP_QUAD_FEATS,
    GP_QUAD_POINTS, GP_SELECT_TABLE_MAX, SMEM_BANKS, GPQuadDualDynamics, GPQuadDynamics,
    GPQuadSelectDynamics, gp_dual_layout)
from ad_mpc_tpu_torch.models.gp_routed import GP_QUAD_ROUTED_POINTS
from ad_mpc_tpu_torch.models.pacejka import PacejkaDynamics
from ad_mpc_tpu_torch.models.quadrotor import QuadDragDynamics, QuadDynamics
from ad_mpc_tpu_torch.ops._build import CSRC
from ad_mpc_tpu_torch.ops.cuda_lq import (
    MAX_BLOCKS_SM, SMEM_BLOCK_MAX, SMEM_BLOCK_RESERVED, SMEM_SM)
from ad_mpc_tpu_torch.ops.cuda_vde import (
    REGS_SM, THREADS_SM, WARP, block_scenarios, lane_work, make_vde, rows_staged,
    vde_geometry)
from ad_mpc_tpu_torch.ops.integrators import discrete_step
from ad_mpc_tpu_torch.testing import (
    dual_gp_ps, quad_traj, random_traj, routed_quad_inputs)
from ad_mpc_tpu_torch.testing import one_thread  # noqa: F401 (autouse)

NX, NU, DT = 13, 4, 0.1
NV = NX + NU
# GPQuadDyn's static shared table: X and a, each dim padded by a float, 1/l
# and y_mean (csrc/vde_gp_quad.cu).
GP_QUAD_STATIC = 4 * GP_QUAD_DIMS * (GP_QUAD_POINTS * (GP_QUAD_FEATS + 1) + 2
                                     + GP_QUAD_FEATS + 1)
# GPBicycleDyn's static shared table (csrc/vde_gp_bicycle.cu: gp_table).
GP_BICYCLE_STATIC = 4 * gp_table_layout()["floats"]
# Floats of a routed GP quad's p row at its capacity of points
# (csrc/vde_gp_quad_routed.cu: gp_quad_routed_floats, base_pd 0).
ROUTED_P_MAX = GP_QUAD_DIMS * (GP_QUAD_ROUTED_POINTS * (GP_QUAD_FEATS + 1) + GP_QUAD_FEATS + 2)
# Each team functor's sweep: (its source, its traits' macro prefix, the
# sweep's variants, its static shared bytes, the bytes of its largest table
# in dynamic shared memory, the floats of its largest p row that a block
# stages, its (nx, nu, N)). The dual-state GP's traits lie in
# vde_gp_quad_dual.cuh, which both of its sources (with and without the
# drag) include; the drag's in vde_quad.cu beside the quad's; the
# Pacejka's in vde_bicycle.cu.
QUAD, BICYCLE = (NX, NU, 10), (7, 2, 30)
SOURCES = {"vde_gp_quad": ("vde_gp_quad", "GP_QUAD", GP_QUAD_TEAMS, GP_QUAD_STATIC, 0, 0,
                           QUAD),
           "vde_gp_quad_dual": ("vde_gp_quad_dual", "GP_QUAD_DUAL", TABLE_TEAMS, 0,
                                4 * GP_DUAL_TABLE_MAX, 0, QUAD),
           "vde_gp_quad_select": ("vde_gp_quad_select", "GP_QUAD_SELECT", TABLE_TEAMS, 0,
                                  4 * GP_SELECT_TABLE_MAX, 0, QUAD),
           "vde_quad": ("vde_quad", "QUAD", QUAD_TEAMS, 0, 0, 0, QUAD),
           "vde_gp_quad_routed": ("vde_gp_quad_routed", "GP_QUAD_ROUTED", ROUTED_TEAMS,
                                  0, 0, ROUTED_P_MAX, QUAD),
           "vde_quad_drag": ("vde_quad", "QUAD_DRAG", DRAG_TEAMS, 0, 0, 0, QUAD),
           "vde_gp_bicycle": ("vde_gp_bicycle", "GP_BICYCLE", GP_BICYCLE_TEAMS,
                              GP_BICYCLE_STATIC, 0, 0, BICYCLE),
           "vde_pacejka": ("vde_bicycle", "PACEJKA", PACEJKA_TEAMS, 0, 0, 0, BICYCLE)}
# The quads' team widths, and the bicycles'.
TEAMS = sorted({v[0] for s in SOURCES.values() if s[6] == QUAD for v in s[2]})
BICYCLE_TEAMS = sorted({v[0] for s in SOURCES.values() if s[6] == BICYCLE for v in s[2]})


def team_defaults(source):
    """{functor macro prefix: {"ROW_TEAM", "ROW_WARPS", "MIN_BLOCKS"}}: the
    team traits that ``csrc/<source>.cu`` (and its own header
    ``<source>.cuh``, where it has one) is built with when no ``-D``
    overrides them."""
    text = "".join(p.read_text() for p in (CSRC / f"{source}.cu", CSRC / f"{source}.cuh")
                   if p.exists())
    out = {}
    for prefix, trait, n in re.findall(r"#define (\w+?)_(ROW_TEAM|ROW_WARPS|MIN_BLOCKS) (\d+)",
                                       text):
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


def _coverage(geo, rows, nv=NV):
    """{(row, column): times stored}, and the rows whose c is stored, over
    every thread of every block of ``geo`` (``nv`` columns a row)."""
    stored, c_rows = {}, []
    for block in range(geo.grid):
        for thread in range(geo.threads):
            row, cols, writes_c, stores = lane_work(geo, rows, nv, block, thread)
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
    every variant with them; a GP
    quad's team (and the GP bicycle's, beyond a team of one) has a lane
    for each output dim."""
    path, prefix, variants, _, _, _, _ = SOURCES[source]
    d = team_defaults(path)[prefix]
    bulk = re.search(r"#define VDE_BULK_STORE (\d)", (CSRC / "vde.cuh").read_text())
    assert (d["ROW_TEAM"], d["ROW_WARPS"], d["MIN_BLOCKS"], int(bulk.group(1))) == \
        variants[0]
    if prefix.startswith("GP_QUAD"):
        assert all(v[0] >= GP_QUAD_DIMS for v in variants)
    if prefix == "GP_BICYCLE":  # or a thread per row, which sums both itself
        assert all(v[0] == 1 or v[0] >= GP_DIMS for v in variants)


@pytest.mark.parametrize("source,variant", [
    (s, v) for s, (_, _, vs, _, _, _, _) in SOURCES.items() for v in vs])
def test_team_variants_fit_the_card(source, variant):
    """Each variant's block (its tile and the GP quad's or the GP
    bicycle's static table, or the largest cluster table after the tile,
    or the routed GP's largest p rows of a block's scenarios) fits a
    block's 232,448 bytes;
    its launch bounds agree with its block: the block is ROW_WARPS warps,
    MIN_BLOCKS such blocks fit an SM's threads, shared memory and registers
    at the capped count, and the cap leaves at least 64 registers."""
    _, _, _, static, table, row_floats, (nx, nu, N) = SOURCES[source]
    team, rw, min_blocks, _ = variant
    geo = vde_geometry(16384, N, nx, nu, team, rw, min_blocks, static, table, row_floats)
    rows = 4 * row_floats * block_scenarios(geo.rows_per_block, N, 16384)
    assert geo.block_bytes == geo.shared_bytes + static <= SMEM_BLOCK_MAX
    assert geo.threads == 32 * rw and geo.rows_per_block * team == geo.threads
    assert geo.shared_bytes == 4 * geo.rows_per_block * nx * (nx + nu + 1) + table + rows
    assert geo.table_bytes == table and geo.rows_bytes == rows
    assert 64 <= geo.max_registers <= 255
    assert resident_blocks(geo.max_registers, geo.threads, geo.block_bytes) >= min_blocks


def test_team_geometry_refuses_what_the_kernel_cannot_take():
    """A team that does not divide a warp, a block whose rows do not start
    on 16 bytes in c (13 floats a row), and launch bounds that no SM
    holds. (A team of 1, the thread-per-row path's launch, is taken.)"""
    for team in (0, 3, 6):
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


def _team_sweep(dyn, geo, xs, us, ps, dt=DT):
    """The sweep as the team path computes and stores it, in plain PyTorch:
    each lane's columns by one forward-mode JVP of the RK4 map per column
    at its row, c by lane 0, placed by :func:`lane_work`; every entry
    written once."""
    (B, N, nu), nx = us.shape, xs.shape[-1]
    rows, nv = B * N, nx + nu
    x, u = xs[:, :-1].reshape(rows, nx), us.reshape(rows, nu)
    p = ps.repeat_interleave(N, 0)
    step = lambda a, b: discrete_step(dyn, dt, 1, a, b, p)
    seeds = torch.eye(nv, dtype=xs.dtype)
    cols = [torch.func.jvp(step, (x, u), (seeds[j, :nx].expand(rows, nx),
                                          seeds[j, nx:].expand(rows, nu)))[1]
            for j in range(nv)]
    c_all = step(x, u) - xs[:, 1:].reshape(rows, nx)
    A = torch.full((rows, nx, nx), float("nan"), dtype=xs.dtype)
    Bm = torch.full((rows, nx, nu), float("nan"), dtype=xs.dtype)
    c = torch.full((rows, nx), float("nan"), dtype=xs.dtype)
    for block in range(geo.grid):
        for thread in range(geo.threads):
            row, lane_cols, writes_c, stores = lane_work(geo, rows, nv, block, thread)
            if not stores:
                continue
            for j in lane_cols:
                if j < nx:
                    A[row, :, j] = cols[j][row]
                else:
                    Bm[row, :, j - nx] = cols[j][row]
            if writes_c:
                c[row] = c_all[row]
    return A.reshape(B, N, nx, nx), Bm.reshape(B, N, nx, nu), c.reshape(B, N, nx)


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


# ------------------------------------------------- the cluster table

# The cluster tables the functors stage: (clusters, points per cluster).
LAYOUTS = {"synthetic n=32": (2, 32), "fitted gp_flagship_c1": (1, 60),
           "gp_flagship_c2": (2, 60)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cluster_table_reads_lie_in_distinct_banks(layout):
    """A warp's lanes 0-2 of each team read point j, feature k of the
    clusters their rows took for output dims 0-2 at once (X, then a, then
    each centroid's feature): for every (output, cluster) block the
    padded layout (``gp_dual_layout``) puts that read in a bank of its own,
    so that no two such reads conflict whichever clusters the rows took.
    Unpadded, the synthetic layout's 3C blocks of X (96 floats each) would
    all lie in one bank."""
    C, n = LAYOUTS[layout]
    lay = gp_dual_layout(C, n)
    blocks = [(d, c) for d in range(3) for c in range(C)]
    for j in range(n):
        for k in range(3):
            banks = {(lay["X"](d, c) + 3 * j + k) % SMEM_BANKS for d, c in blocks}
            assert len(banks) == len(blocks)
        assert len({(lay["a"](d, c) + j) % SMEM_BANKS for d, c in blocks}) == len(blocks)
    for c in range(C):
        for k in range(3):
            assert len({(lay["centroids"](d) + 3 * c + k) % SMEM_BANKS
                        for d in range(3)}) == 3
    if n == 32:
        assert len({(d * C + c) * 3 * n % SMEM_BANKS for d, c in blocks}) == 1


def test_largest_table_bounds_every_layout():
    """Every layout within the capacity (clusters, and clusters x points per
    output) takes at most the largest table that the kernels' shared memory
    is set for at the library's load (``GP_DUAL_TABLE_MAX``,
    ``GP_SELECT_TABLE_MAX``), whose formulas the sources state."""
    worst = max(gp_dual_layout(C, n)["select_floats"] - GP_SELECT_TABLE_MAX
                for C in range(1, GP_DUAL_CLUSTERS + 1)
                for n in range(1, GP_DUAL_POINTS // C + 1))
    assert worst <= 0
    assert max(gp_dual_layout(C, GP_DUAL_POINTS // C)["floats"]
               for C in range(1, GP_DUAL_CLUSTERS + 1)) <= GP_DUAL_TABLE_MAX
    assert "GP_DUAL_TABLE_MAX = 3 * (4 * GP_DUAL_POINTS + 66 * GP_DUAL_CLUSTERS);" in \
        (CSRC / "vde_models.cuh").read_text()
    assert ("GP_SELECT_TABLE_MAX = GP_DUAL_TABLE_MAX + 9 * GP_DUAL_CLUSTERS + 3;"
            in (CSRC / "vde_gp_quad_select.cu").read_text())


def _jax_ensemble(ens):
    """The JAX package's GPEnsemble with the port ensemble's arrays."""
    return je.GPEnsemble(**{k: (v if isinstance(v, tuple) else jnp.asarray(v))
                            for k, v in ens._asdict().items()})


@pytest.fixture(scope="module")
def two_clusters():
    """A ragged iterate (B=5, N=2) whose body velocities cross the clusters
    of an 8-point two-cluster three-output ensemble: (port ensemble, JAX
    ensemble, xs, us, {case: the JAX package's sweep of it}), each JAX
    sweep computed once for every team width."""
    ens = quad_fleet.make_quad_gp_ensemble(n=8, clusters=2)
    xs, us = quad_traj(np.random.default_rng(23), 5, 2)
    xs[..., 7:10] *= 10.0
    return ens, _jax_ensemble(ens), xs, us, {}


def _hold_team_split(dyn, team, xs, us, ps, want):
    """The team's split (:func:`_team_sweep`) against ``want`` and against
    the port's plain sweep, each at 3e-5."""
    B, N = us.shape[:2]
    args = [torch.as_tensor(a) for a in (xs, us, ps)]
    got = _team_sweep(dyn, vde_geometry(B, N, NX, NU, team, row_warps=4), *args)
    plain = make_vde(dyn, DT, N, NX, NU, ps.shape[1], device="cpu")(*args)
    for g, w, q in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5, rtol=0)
        torch.testing.assert_close(g, q, atol=3e-5, rtol=0)


@pytest.mark.parametrize("team", sorted({v[0] for v in TABLE_TEAMS}))
def test_team_split_of_the_dual_gp_sweep_matches_jax(two_clusters, team):
    """The dual-state GP (``GPQuadDualDyn``) on p rows that mix the trigger
    (node 0: mu0, no GP) with GP rows whose outputs take either cluster:
    the team's split against the JAX package's QuadMPC ensemble dynamics
    (``ad_mpc_tpu/control/mpc.py:264-283``, its solver's discrete map
    linearized per stage) at 3e-5."""
    ens, ens_j, xs, us, wants = two_clusters
    B, N = us.shape[:2]
    ps = dual_gp_ps(np.random.default_rng(4), B, ens, trigger_every=2)
    assert set(ps[:, 0]) == {0.0, 1.0} and set(ps[1::2, 4:].ravel()) == {0.0, 1.0}
    if "dual" not in wants:
        F = JaxQuadMPC(spec=jax_quad_spec(n_nodes=N, t_horizon=N * DT), ensemble=ens_j,
                       dtype=jnp.float32).solver._F
        wants["dual"] = jax.vmap(lambda a, b, p: linearize_p(F, a, b, jnp.tile(p, (N, 1))))(
            jnp.asarray(xs), jnp.asarray(us), jnp.asarray(ps))
    _hold_team_split(GPQuadDualDynamics(ens), team, xs, us, ps, wants["dual"])


@pytest.mark.parametrize("pinned", [False, True], ids=["nearest", "pinned"])
@pytest.mark.parametrize("team", sorted({v[0] for v in TABLE_TEAMS}))
def test_team_split_of_the_select_gp_sweep_matches_jax(two_clusters, team, pinned):
    """The select GP (``GPQuadSelectDyn``), the nearest centroid at every
    evaluation or every output pinned to cluster 1: the team's split
    against the JAX package's ``quad_residual_fn``
    (``ad_mpc_tpu/learned/ensemble.py:216-244``) plus the quad, discretized
    and linearized, at 3e-5."""
    ens, ens_j, xs, us, wants = two_clusters
    fixed = 1 if pinned else None
    if ("select", fixed) not in wants:
        res = je.quad_residual_fn(ens_j, fixed_cluster=fixed)
        F = discretize(lambda x, u: jq.quad_dynamics(x, u, jq.QuadrotorParams()) + res(x, u),
                       DT, 1)
        wants["select", fixed] = jax.vmap(lambda a, b: linearize(F, a, b))(
            jnp.asarray(xs), jnp.asarray(us))
    _hold_team_split(GPQuadSelectDynamics(ens, fixed_cluster=fixed), team, xs, us,
                     np.zeros((us.shape[0], 0), np.float32), wants["select", fixed])


# ------------------------------------------------- the drag and the routed GP

RDRV = quad_fleet.fitted_rdrv_d()


def _slab(f_one, x0, u0):
    """(f, c): a dynamics on one state, (13,) and (4,), as the Pallas sweep
    calls it, on (13, Nt, B) and (4, Nt, B) slabs with entries leading, and
    the float constants of ``f_one`` (its parameters' arrays, which a
    Pallas kernel may not capture), flattened into the p row c that ``f``
    reads them from."""
    closed = jax.make_jaxpr(f_one)(x0, u0)
    shapes = [np.shape(k) for k in closed.consts]
    c = jnp.concatenate([jnp.ravel(jnp.asarray(k)) for k in closed.consts]).astype(jnp.float32)

    def f_conv(xx, uu, *ks):
        return jax.core.eval_jaxpr(closed.jaxpr, ks, xx, uu)[0]

    def f(x, u, p):
        def one(xx, uu, pp):
            ks, at = [], 0
            for shape in shapes:
                size = int(np.prod(shape))
                ks.append(pp[at:at + size].reshape(shape))
                at += size
            return f_conv(xx, uu, *ks)

        out = jax.vmap(one)(x.reshape(NX, -1).T, u.reshape(NU, -1).T,
                            p.reshape(p.shape[0], -1).T)
        return out.T.reshape(x.shape)

    return f, c


@pytest.fixture(scope="module")
def drag_case():
    """A ragged quad iterate (B=3, N=5) with velocities where the drag
    matters, and the JAX package's Pallas sweep (interpret mode) of its
    ``quad_dynamics(rdrv_d=D)`` with the fitted D."""
    B, N = 3, 5
    xs, us = quad_traj(np.random.default_rng(24), B, N)
    xs[..., 7:10] *= 10.0
    f, c = _slab(lambda x, u: jq.quad_dynamics(x, u, jq.QuadrotorParams(), RDRV),
                 jnp.asarray(xs[0, 0]), jnp.asarray(us[0, 0]))
    pallas = jax_make_vde(f, DT, N, NX, NU, c.size, block_b=8, interpret=True)
    want = pallas(jnp.asarray(xs), jnp.asarray(us), jnp.tile(c, (B, 1)))
    return xs, us, [np.asarray(w) for w in want]


@pytest.mark.parametrize("team", sorted({v[0] for v in DRAG_TEAMS}))
def test_team_split_of_the_drag_sweep_matches_jax(drag_case, team):
    """Each team width of the drag's sweep (``QuadDragDyn``) recovers the
    JAX package's Pallas sweep of ``quad_dynamics(rdrv_d=D)`` at 3e-5."""
    xs, us, want = drag_case
    B, N = us.shape[:2]
    geo = vde_geometry(B, N, NX, NU, team, row_warps=4)
    got = _team_sweep(QuadDragDynamics(RDRV), geo, torch.as_tensor(xs),
                      torch.as_tensor(us), torch.zeros((B, 0)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=3e-5, rtol=0)


@pytest.fixture(scope="module")
def routed_case():
    """A ragged iterate (B=5, N=2) of the routed GP quad on an 8-point
    two-cluster three-output ensemble, each scenario's p packed at its body
    velocity moved to a centroid of cluster b mod 2, both clusters in the
    launch; and the JAX package's ``param_residual_dynamics(...,
    quad_frame=True)`` on the quad's lane form, discretized and linearized
    by XLA per scenario on the same p."""
    ens = quad_fleet.make_quad_gp_ensemble(n=8, clusters=2)
    dyn, xs, us, ps, present = routed_quad_inputs(ens, 5, 2, 25, "cpu")
    assert present == [0, 1]
    f3, p_dim, _ = jl.param_residual_dynamics(_jax_ensemble(ens), _jax_quad, 0,
                                              quad_frame=True)
    assert p_dim == dyn.p_dim == ps.shape[1]

    def one(a, b, p):
        return linearize(discretize(lambda x, u: f3(x, u, p), DT, 1), a, b)

    xs, us, ps = (t.numpy() for t in (xs, us, ps))
    want = jax.vmap(one)(jnp.asarray(xs), jnp.asarray(us), jnp.asarray(ps))
    return dyn, xs, us, ps, want


@pytest.mark.parametrize("team", sorted({v[0] for v in ROUTED_TEAMS}))
def test_team_split_of_the_routed_gp_sweep_matches_jax(routed_case, team):
    """Each team width of the routed GP quad's sweep (``GPQuadRoutedDyn``)
    against the JAX package's routed dynamics linearized by XLA and against
    the port's plain sweep, each at 3e-5."""
    dyn, xs, us, ps, want = routed_case
    _hold_team_split(dyn, team, xs, us, ps, want)


@pytest.mark.parametrize("N", [1, 2, 10])
@pytest.mark.parametrize("B", [1, 5, 37])
@pytest.mark.parametrize("team", sorted({v[0] for v in ROUTED_TEAMS}))
def test_staged_p_rows_geometry(team, B, N):
    """The routed GP quad's launch with its p rows (the fitted 60-point
    layout, 735 floats): every row and column stored once and every c
    once; the dynamic shared bytes are the kernel's (``launch_vde_team``:
    the tile, then block_scenarios p rows where N > 1, none at N = 1); and
    each block's rows read no more scenarios than it stages."""
    pd = GP_QUAD_DIMS * (60 * (GP_QUAD_FEATS + 1) + GP_QUAD_FEATS + 2)
    geo = vde_geometry(B, N, NX, NU, team, 4, row_floats=pd)
    rows = B * N
    stored, c_rows = _coverage(geo, rows)
    assert stored == {(r, j): 1 for r in range(rows) for j in range(NV)}
    assert sorted(c_rows) == list(range(rows))
    tile = geo.rows_per_block * NX * (NV + 1)
    staged = block_scenarios(geo.rows_per_block, N, B) if N > 1 else 0
    assert rows_staged(N) == (N > 1)
    assert geo.shared_bytes == 4 * (tile + pd * staged) and geo.rows_bytes == 4 * pd * staged
    for block in range(geo.grid if N > 1 else 0):
        first = block * geo.rows_per_block
        last = min(first + geo.rows_per_block, rows) - 1
        assert last // N - first // N + 1 <= staged


def test_routed_default_fits_every_horizon():
    """The committed routed team's block, with the largest p rows its
    functor takes (64 points), fits the SM for MIN_BLOCKS blocks at every
    horizon of the port's solvers (N = 2 stages the most scenarios)."""
    d = team_defaults("vde_gp_quad_routed")["GP_QUAD_ROUTED"]
    for N in range(1, 41):
        geo = vde_geometry(16384, N, NX, NU, d["ROW_TEAM"], d["ROW_WARPS"],
                           d["MIN_BLOCKS"], row_floats=ROUTED_P_MAX)
        assert resident_blocks(geo.max_registers, geo.threads, geo.block_bytes) >= \
            d["MIN_BLOCKS"]


def _staged_reads(geo, B, N, pd, n):
    """{read: {word address: bank}} of one warp's GP reads, for each warp of
    each block of ``geo`` at B scenarios of N stages and for each read of
    ``gp_table_mean`` (point j's feature k of X, its weight a, 1/l's k,
    y_mean): lanes 0-2 of every team read output dim d = lane of their
    scenario's staged copy, (b - b_first) pd + d (4n + 5) + offset."""
    per = n * (GP_QUAD_FEATS + 1) + GP_QUAD_FEATS + 2
    offsets = ([("X", j, k, j * GP_QUAD_FEATS + k) for j in range(n)
                for k in range(GP_QUAD_FEATS)]
               + [("a", j, 0, n * GP_QUAD_FEATS + j) for j in range(n)]
               + [("inv_l", 0, k, n * GP_QUAD_FEATS + n + k) for k in range(GP_QUAD_FEATS)]
               + [("y_mean", 0, 0, n * GP_QUAD_FEATS + n + GP_QUAD_FEATS + 1)])
    rows = B * N
    for block in range(geo.grid):
        b_first = block * geo.rows_per_block // N
        for warp in range(geo.threads // WARP):
            lanes = [(t, lane_work(geo, rows, NV, block, t)[0])
                     for t in range(warp * WARP, (warp + 1) * WARP) if t % geo.team < 3]
            for name, j, k, off in offsets:
                words = {(row // N - b_first) * pd + (t % geo.team) * per + off
                         for t, row in lanes}
                yield (block, warp, name, j, k), words


@pytest.mark.parametrize("N", [2, 10])
@pytest.mark.parametrize("n", [32, 60], ids=["synthetic_n32", "fitted_n60"])
@pytest.mark.parametrize("team", sorted({v[0] for v in ROUTED_TEAMS}))
def test_staged_p_rows_reads_lie_in_distinct_banks(team, n, N):
    """Lanes 0-2 of a routed GP team read one point of output dims 0-2 of
    their scenario's staged p row at once, and a warp's teams span several
    scenarios (up to 5 at N = 2 with 4 lanes a team): the distinct words
    that a warp reads at once lie in distinct banks, unpadded, for the
    synthetic 32-point (399 floats a row) and the fitted 60-point (735)
    layouts, in every warp of ragged launches."""
    pd = GP_QUAD_DIMS * (n * (GP_QUAD_FEATS + 1) + GP_QUAD_FEATS + 2)
    for B in (5, 37):
        geo = vde_geometry(B, N, NX, NU, team, 4, row_floats=pd)
        for where, words in _staged_reads(geo, B, N, pd, n):
            assert len({w % SMEM_BANKS for w in words}) == len(words), (where, words)


# ------------------------------------------------- the bicycles' teams

BNX, BNU, BDT = 7, 2, 0.05
BNV = BNX + BNU


@pytest.mark.parametrize("team", BICYCLE_TEAMS)
@pytest.mark.parametrize("B,N", [(1, 30), (37, 30), (5, 3)])
def test_bicycle_team_geometry_stores_each_row_and_column_once(team, B, N):
    """At nx=7, nu=2 (the Pacejka's and the GP bicycle's 9 columns) and
    ragged batches: each of the B*N rows has each of its 9 columns and its
    c stored exactly once, and the last block's spare threads store
    nothing; a lane's columns past the 9th (2 lanes of 5, 4 of 3, 8 of 2)
    are computed and not stored. A team of 1 is the thread-per-row path's
    launch: a thread per row with every column, a block of 128 rows."""
    geo = vde_geometry(B, N, BNX, BNU, team, row_warps=4)
    rows = B * N
    stored, c_rows = _coverage(geo, rows, BNV)
    assert stored == {(r, j): 1 for r in range(rows) for j in range(BNV)}
    assert sorted(c_rows) == list(range(rows))
    assert geo.grid * geo.rows_per_block >= rows > (geo.grid - 1) * geo.rows_per_block
    assert geo.cols == -(-BNV // team)
    assert geo.shared_bytes == 4 * geo.rows_per_block * BNX * (BNV + 1)
    if team == 1:
        assert (geo.cols, geo.rows_per_block, geo.threads) == (BNV, 128, 128)


def test_gp_bicycle_table_reads_lie_in_distinct_banks():
    """Lanes 0 and 1 of every team of a warp read point j, feature k of
    output dims 0 and 1 at once (X, then a, then 1/l's k and y_mean): in
    ``gp_table_layout`` the two reads lie in distinct banks, whereas
    unpadded (128 and 32 floats apart) they would share one; every block of
    X and a, and 1/l, starts on 16 bytes (the point loop's vector loads);
    the layout is the source's."""
    lay = gp_table_layout()
    for j in range(GP_POINTS):
        for k in range(GP_FEATS):
            assert len({(lay["X"](d) + GP_FEATS * j + k) % SMEM_BANKS
                        for d in range(GP_DIMS)}) == GP_DIMS
        assert len({(lay["a"](d) + j) % SMEM_BANKS for d in range(GP_DIMS)}) == GP_DIMS
    for k in range(GP_FEATS):
        assert len({(lay["inv_l"] + GP_FEATS * d + k) % SMEM_BANKS
                    for d in range(GP_DIMS)}) == GP_DIMS
    assert len({(lay["y_mean"] + d) % SMEM_BANKS for d in range(GP_DIMS)}) == GP_DIMS
    assert (GP_POINTS * GP_FEATS) % SMEM_BANKS == GP_POINTS % SMEM_BANKS == 0
    assert all(lay["X"](d) % 4 == lay["a"](d) % 4 == 0 for d in range(GP_DIMS))
    assert lay["inv_l"] % 4 == 0
    src = (CSRC / "vde_gp_bicycle.cu").read_text()
    for line in ("constexpr int GP_PAD = 4;",
                 "constexpr int GP_X_DIM = GP_POINTS * GP_FEATS + GP_PAD;",
                 "constexpr int GP_A_DIM = GP_POINTS + GP_PAD;",
                 "__shared__ __align__(16) float gp_table[GP_TABLE];",
                 "constexpr int GP_A = GP_X + GP_DIMS * GP_X_DIM;",
                 "constexpr int GP_INV_L = GP_A + GP_DIMS * GP_A_DIM;",
                 "constexpr int GP_Y_MEAN = GP_INV_L + GP_DIMS * GP_FEATS;",
                 "constexpr int GP_TABLE = GP_Y_MEAN + GP_DIMS;"):
        assert line in src


def _bicycle_split(dyn, f_j, team, xs, us, ps):
    """Each team width's split (:func:`_team_sweep`) of ``dyn``'s sweep
    against the JAX package's ``f_j`` discretized and linearized by XLA per
    scenario, and against the port's plain sweep, each at 2e-5."""
    B, N = us.shape[:2]
    F = lambda p: discretize(lambda xx, uu: f_j(xx, uu, p), BDT, 1)
    want = jax.vmap(lambda a, b, p: linearize(F(p), a, b))(
        *(jnp.asarray(a) for a in (xs, us, ps)))
    args = [torch.as_tensor(a) for a in (xs, us, ps)]
    got = _team_sweep(dyn, vde_geometry(B, N, BNX, BNU, team, row_warps=4), *args, dt=BDT)
    plain = make_vde(dyn, BDT, N, BNX, BNU, ps.shape[1], device="cpu")(*args)
    for g, w, q in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0)
        torch.testing.assert_close(g, q, atol=2e-5, rtol=0)


@pytest.mark.parametrize("team", BICYCLE_TEAMS)
def test_team_split_of_the_pacejka_sweep_matches_jax(team):
    """The c4 Pacejka with its 5-entry p as the fleet draws it
    (``fleet.pacejka_draw``), one scenario at the sweep's lowest friction:
    the team's split against the JAX package's ``pacejka_dynamics_p``."""
    B, N = 3, 5
    xs, us = random_traj(np.random.default_rng(25), B, N, BNX, BNU)
    _, ps = fleet.pacejka_draw(B)
    ps = np.array(ps, np.float32)
    ps[1, 0] = 0.6
    params = jp.PacejkaParams()
    _bicycle_split(PacejkaDynamics(), lambda x, u, p: jp.pacejka_dynamics_p(x, u, p, params),
                   team, xs, us, ps)


@pytest.mark.parametrize("team", BICYCLE_TEAMS)
def test_team_split_of_the_gp_bicycle_sweep_matches_jax(team):
    """The GP bicycle on the 6-point twin of the bench's ensemble
    (``fleet.make_gp_bicycle(6)``): the team's split against the JAX
    package's bicycle plus ``lane_residual_terms`` of the same ensemble."""
    dyn = fleet.make_gp_bicycle(6)
    ens_j, params = _jax_ensemble(dyn.ensemble), BicycleParams()

    def f_j(x, u, p):
        return jl.add_rows(bicycle_dynamics(x, u, params, switch=p[0]),
                           jl.lane_residual_terms(ens_j, x))

    B, N = 3, 5
    xs, us = random_traj(np.random.default_rng(26), B, N, BNX, BNU)
    _bicycle_split(dyn, f_j, team, xs, us, np.ones((B, 1), np.float32))
