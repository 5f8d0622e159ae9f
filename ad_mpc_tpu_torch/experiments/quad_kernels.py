"""Design choices of the quad's kernels on the H100, measured at c5's and
c6's shapes (B=16384, N=10, nx=13, nu=4).

    python -m ad_mpc_tpu_torch.experiments.quad_kernels [--out PATH]
        [--only quad,gp_quad,drag,dual,select,routed,lq]

1. The VDE sweep with the quad functor (``csrc/vde_quad.cu``), a team of
   lanes per row (``vde.cuh:vde_team``), built once per variant of its
   traits, all ``nvcc`` started together: ``-DQUAD_ROW_TEAM`` (lanes per
   row), ``-DQUAD_ROW_WARPS`` (warps per block) and ``-DQUAD_MIN_BLOCKS``
   (the blocks per SM its registers are capped for), and the block's tile
   copied out by bulk asynchronous copies or by 16-byte stores
   (``-DVDE_BULK_STORE=1`` or ``0``):
   registers and spills from ``ptxas``, the launch geometry
   (``cuda_vde.vde_geometry``) and the blocks resident per SM
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), device time by
   CUDA-graph replay (``experiments.graph_ms``) warm and cold at B=16384
   and warm at B=1, the largest error against ``vde_plain`` (held at
   3e-5) and whether its bits are the first variant's (the committed
   traits).
2. The same for the GP-quad functor of c6 (``GPQuadDyn``, the
   ``GP_QUAD_`` traits), on the synthetic 32-point ensemble and the
   fitted 60-point one, each held to ``vde_plain`` (3e-5 on the synthetic
   ensemble; on the fitted one its distance is printed).
3. QuadMPC's RDRv drag (``QuadDragDyn``, ``-DQUAD_DRAG_ROW_TEAM`` and the
   rest), a team functor as 1., with the fitted D, held to ``vde_plain`` at
   3e-5; its B=1 row also the sweep of QuadMPC's RTI solve in the
   ``rdrv_d`` mode.
4. QuadMPC's cluster-table GP functors as team functors, as 1. and 2.
   (``-DGP_QUAD_DUAL_ROW_TEAM`` and the rest): the dual-state GP
   (``GPQuadDualDyn``) on the fitted model, p drawn by
   ``testing.dual_gp_ps`` with the trigger on every tenth scenario, and the
   select functor (``GPQuadSelectDyn``) on the fitted two-cluster
   ``gp_flagship_c2``, the velocities scaled by 5 across its clusters (as
   ``testing.margin_quad_traj`` draws them); the fitted GPs' distances
   from ``vde_plain`` printed. Their B=1 row is the sweep of QuadMPC's RTI
   solve in the mode that runs the functor (``ensemble=`` as 10 one-stage
   scenarios; ``quad_residual_fn`` of ``gp_flagship_c2``), as
   ``c2_kernels.py:quad_solve_inputs`` captures it.
5. The routed body-frame GP (``GPQuadRoutedDyn``,
   ``-DGP_QUAD_ROUTED_ROW_TEAM`` and the rest), a team functor whose block
   stages its scenarios' p rows after its tile, on the fitted two-cluster
   ``gp_flagship_c2``, each scenario's p packed at its body velocity moved
   to a centroid of cluster b mod 2 (``testing.routed_quad_inputs``); its
   distance from ``vde_plain`` printed.
6. The 13x4 LQ kernel (``csrc/lq_ipm_wide.cuh``) on the QPs of the third
   c5 tick at B=16384, for every number of scenarios per block that fits:
   resident blocks and scenarios per SM
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), shared bytes per
   scenario, device time by graph replay, and whether its bits are those of
   the geometry ``lq_geometry`` picks (a scenario's arithmetic does not
   depend on its block).
"""

from __future__ import annotations

import argparse
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ad_mpc_tpu_torch.experiments import (
    card, graph_ms, quad_fleet, require_cuda, tf32, tick_qp_inputs)
from ad_mpc_tpu_torch.models.gp_quad import GPQuadDynamics
from ad_mpc_tpu_torch.models.quadrotor import QuadDynamics
from ad_mpc_tpu_torch.ops import _build
from ad_mpc_tpu_torch.ops.cuda_lq import MAX_TEAMS
from ad_mpc_tpu_torch.ops.cuda_vde import make_vde, vde_plain
from ad_mpc_tpu_torch.testing import quad_traj

# Team functors: (lanes per row, row warps, min blocks per SM, bulk store);
# the first is the committed default (the source's #defines and
# vde.cuh's VDE_BULK_STORE).
QUAD_TEAMS = ((8, 4, 4, 1), (8, 4, 4, 0), (8, 4, 3, 1), (8, 4, 5, 1),
              (4, 4, 2, 1), (4, 4, 2, 0), (16, 4, 4, 1), (32, 4, 5, 1))
GP_QUAD_TEAMS = ((4, 4, 2, 1), (4, 4, 2, 0), (4, 4, 3, 1), (4, 2, 5, 1),
                 (8, 4, 2, 1), (8, 4, 3, 1))
# The cluster-table functors (dual-state and select GPs): every variant's
# block holds its tile and the largest table, MIN_BLOCKS of them an SM
# (tests/test_torch_vde_team.py).
TABLE_TEAMS = ((4, 4, 2, 1), (4, 4, 2, 0), (4, 4, 3, 1), (4, 2, 4, 1),
               (8, 4, 2, 1), (8, 4, 3, 1), (16, 4, 2, 1))
# The drag (QuadDragDyn) from the quad's traits, and the routed GP quad
# (GPQuadRoutedDyn) from the GP quad's; every variant's block holds its
# tile and, for the routed GP, its scenarios' largest p rows, MIN_BLOCKS of
# them an SM (tests/test_torch_vde_team.py).
DRAG_TEAMS = ((4, 4, 2, 1), (4, 4, 2, 0), (4, 4, 3, 1), (8, 4, 4, 1), (8, 4, 3, 1),
              (8, 4, 2, 1), (8, 4, 5, 1), (16, 4, 4, 1), (32, 4, 5, 1))
ROUTED_TEAMS = ((4, 4, 2, 1), (4, 4, 2, 0), (4, 4, 3, 1), (4, 2, 5, 1),
                (8, 4, 2, 1), (8, 4, 3, 1), (16, 4, 2, 1))


def _team_defines(team, rw, min_blocks, bulk, model="QUAD"):
    return (f"{model}_ROW_TEAM={team}", f"{model}_ROW_WARPS={rw}",
            f"{model}_MIN_BLOCKS={min_blocks}", f"VDE_BULK_STORE={bulk}")


def _cases(kind, B):
    """{case: (dynamics, ps)} and the variants' names of one section."""
    from ad_mpc_tpu_torch.experiments.quad_fleet import (
        fitted_ensemble, fitted_ensemble_c2, fitted_rdrv_d, make_quad_gp_ensemble)
    from ad_mpc_tpu_torch.models.gp_quad import GPQuadDualDynamics, GPQuadSelectDynamics
    from ad_mpc_tpu_torch.models.quadrotor import QuadDragDynamics
    from ad_mpc_tpu_torch.testing import dual_gp_ps, routed_quad_inputs

    none = torch.zeros((B, 0), device="cuda")
    team = ("team", "rw", "min_blocks", "bulk")
    if kind == "quad":
        return {"quad": (QuadDynamics(), none)}, team
    if kind == "gp_quad":
        return {"n=32": (GPQuadDynamics(make_quad_gp_ensemble()), none),
                "n=60": (GPQuadDynamics(fitted_ensemble()), none)}, team
    if kind == "drag":
        return {"drag": (QuadDragDynamics(fitted_rdrv_d()), none)}, team
    if kind == "select":
        return {"select c2": (GPQuadSelectDynamics(fitted_ensemble_c2()), none)}, team
    if kind == "routed":
        dyn, _, _, ps, _ = routed_quad_inputs(fitted_ensemble_c2(), B, 10, 13, "cuda")
        return {"routed c2": (dyn, ps)}, team
    ens = fitted_ensemble()
    ps = torch.as_tensor(dual_gp_ps(np.random.default_rng(31), B, ens), device="cuda")
    return {"dual n=60": (GPQuadDualDynamics(ens), ps)}, team


def _solve_kw(kind):
    """QuadMPC's keywords of the mode whose RTI solve runs the functor
    ``kind`` (its B=1 row; ``chip_smoke.py:quad_modes``' ``rdrv``,
    ``ensemble`` and ``residual_fn_c2``)."""
    from ad_mpc_tpu_torch.experiments.quad_fleet import (
        fitted_ensemble, fitted_ensemble_c2, fitted_rdrv_d)
    from ad_mpc_tpu_torch.learned.ensemble import quad_residual_fn

    return {"drag": {"rdrv_d": fitted_rdrv_d()},
            "dual": {"ensemble": fitted_ensemble()},
            "select": {"residual_fn": quad_residual_fn(fitted_ensemble_c2())}}[kind]


VARIANTS = {
    "quad": (QUAD_TEAMS, lambda v: _team_defines(*v)),
    "gp_quad": (GP_QUAD_TEAMS, lambda v: _team_defines(*v, model="GP_QUAD")),
    "drag": (DRAG_TEAMS, lambda v: _team_defines(*v, model="QUAD_DRAG")),
    "dual": (TABLE_TEAMS, lambda v: _team_defines(*v, model="GP_QUAD_DUAL")),
    "select": (TABLE_TEAMS, lambda v: _team_defines(*v, model="GP_QUAD_SELECT")),
    "routed": (ROUTED_TEAMS, lambda v: _team_defines(*v, model="GP_QUAD_ROUTED")),
}


def vde_variants(kind="quad", B=16384, N=10, dt=0.1):
    """One row per variant of a functor's traits (``kind``: the quad, the
    GP quad, the drag, the dual-state GP, the select GP or the routed GP
    quad), each a team functor: its geometry, its blocks per SM, its cold
    time and its time at B=1 (also on QuadMPC's solve inputs for the drag
    and the cluster-table functors, ``solve_b1_ms``)."""
    from ad_mpc_tpu_torch.experiments.c2_kernels import quad_solve_inputs

    variants, defines = VARIANTS[kind]
    cases, keys = _cases(kind, B)
    source = next(iter(cases.values()))[0].cuda_source
    with ThreadPoolExecutor(len(variants)) as pool:
        list(pool.map(lambda v: _build.build_all((source,), defines(v)), variants))
    xs, us = (torch.as_tensor(a, device="cuda")
              for a in quad_traj(np.random.default_rng(13), B, N))
    if kind == "select":
        xs[..., 7:10] *= 5.0  # across the clusters
    solve = None
    if kind in ("drag", "dual", "select"):
        mpc, b1_args, _ = quad_solve_inputs("cuda", _solve_kw(kind))
        solve = mpc.solver.vde, b1_args
    rows = {}
    for case, (dyn, ps) in cases.items():
        want = vde_plain(dyn, dt, 1, xs, us, ps)
        first = None
        for v in variants:
            vde = make_vde(dyn, dt, N, 13, 4, ps.shape[1], device="cuda")
            vde.defines = defines(v)
            got = vde(xs, us, ps)
            first = got if first is None else first
            res = _build.functor_resources(dyn.cuda_source, "vde_kernel",
                                           dyn.cuda_functor, vde.defines)
            name = "_".join(f"{k}{n}" for k, n in zip(keys, v))
            row = rows[f"{case} {name}" if len(cases) > 1 else name] = res | dict(
                zip(keys, v)) | {
                "max_abs_err": max(float((g - w).abs().max())
                                   for g, w in zip(got, want)),
                "bits_as_default": all(torch.equal(g, f)
                                       for g, f in zip(got, first)),
                "ms": graph_ms(lambda: vde(xs, us, ps)),
            }
            x1, u1, p1 = xs[:1], us[:1], ps[:1]
            geo = vde.geometry(B)
            row |= {"geometry": geo._asdict(),
                    "blocks_per_sm": vde.occupancy(B),
                    "cold_ms": graph_ms(lambda: vde(xs, us, ps), cold=True),
                    "b1_ms": graph_ms(lambda: vde(x1, u1, p1))}
            row["warps_per_sm"] = row["blocks_per_sm"] * geo.threads // 32
            if solve is not None:
                sweep, b1_args = solve
                sweep.defines = vde.defines
                row["solve_b1_ms"] = graph_ms(lambda: sweep(*b1_args))
                row["solve_b1_cold_ms"] = graph_ms(lambda: sweep(*b1_args), cold=True)
                sweep.defines = ()
    return rows


def lq_teams(B=16384):
    tick, init, solver, _ = quad_fleet.build_quad_fleet(device="cuda")
    args = tick_qp_inputs(tick, init, solver, B)
    qp = solver.qp
    default = qp.geometry_for(B).teams
    ref = qp(*args)
    rows = {}
    for s in range(1, MAX_TEAMS + 1):
        qp.teams = s
        try:
            geo = qp.geometry
        except ValueError:
            continue
        got = qp(*args)
        row = rows[s] = {
            "threads": geo.threads, "block_bytes": geo.block_bytes,
            "scenario_bytes": 4 * geo.pitch, "blocks_per_sm": qp.occupancy(),
            "bits_as_default": all(torch.equal(g, r) for g, r in zip(got, ref)),
            "ms": graph_ms(lambda: qp(*args), inner=5)}
        row["scenarios_per_sm"] = s * row["blocks_per_sm"]
    qp.teams = None
    return {"default_teams": default, "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result to this JSON file")
    ap.add_argument("--only", default="quad,gp_quad,drag,dual,select,routed,lq",
                    help="the sections to measure, comma-separated")
    args = ap.parse_args(argv)
    require_cuda("cuda")
    only = args.only.split(",")
    res = {"device": card()}
    with tf32(False):
        for kind in ("quad", "gp_quad", "drag", "dual", "select", "routed"):
            if kind in only:
                res[f"vde_{kind}"] = vde_variants(kind)
        if "lq" in only:
            res["lq"] = lq_teams()
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)


if __name__ == "__main__":
    main()
