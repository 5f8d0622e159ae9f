"""Team sweeps of the c4 Pacejka and c3 GP-bicycle functors of the VDE
kernel on the H100, at their bench shapes (B=16384, N=30, nx=7, nu=2; c4's
fleet at B=4096).

    python -m ad_mpc_tpu_torch.experiments.bicycle_kernels [--out PATH]
        [--only pacejka,gp_bicycle]

Each functor runs a team of lanes per row (``vde.cuh:vde_team``) or, as
a team of one, a thread per row (the committed default), its source
(``csrc/vde_bicycle.cu``, ``csrc/vde_gp_bicycle.cu``) built once per
variant of its traits, all ``nvcc`` started together:
``-D{PACEJKA,GP_BICYCLE}_ROW_TEAM`` (lanes per row: 1, 2, 4 or 8, of 9, 5,
3 or 2 of the 9 tangent columns), ``..._ROW_WARPS`` (warps per block) and
``..._MIN_BLOCKS`` (the blocks per SM its registers are capped for), and
the block's tile copied out by bulk asynchronous copies or by 16-byte
stores (``-DVDE_BULK_STORE=1`` or ``0``). For each variant: registers and
spills from ``ptxas``, the launch geometry (``cuda_vde.vde_geometry``)
and the blocks and warps resident per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), device time by
CUDA-graph replay (``experiments.graph_ms``) warm and cold at B=16384 and
warm at B=4096, the largest error against ``vde_plain`` (held at 2e-5:
the script exits 1 where a variant is further) and whether its bits are
the first variant's (the committed traits). The
inputs are the smoke's (``testing.pacejka_inputs``,
``testing.gp_bicycle_inputs`` with the bench's 32-point ensemble).
"""

from __future__ import annotations

import argparse
import json
from concurrent.futures import ThreadPoolExecutor

import torch

from ad_mpc_tpu_torch.experiments import card, graph_ms, require_cuda, tf32
from ad_mpc_tpu_torch.ops import _build
from ad_mpc_tpu_torch.ops.cuda_vde import make_vde, vde_plain
from ad_mpc_tpu_torch.testing import gp_bicycle_inputs, pacejka_inputs

# Variants: (lanes per row, row warps, min blocks per SM, bulk store); the
# first of each is the committed default (the source's #defines and
# vde.cuh's VDE_BULK_STORE): a team of 1, the thread-per-row path with all
# 9 tangents (its warps' 16-byte stores; the bulk flag is not read), which
# every team variant lost to (PERF.md). Every variant's block fits an SM
# MIN_BLOCKS times (tests/test_torch_vde_team.py).
PACEJKA_TEAMS = ((1, 4, 1, 1), (1, 4, 3, 1), (1, 4, 4, 1), (2, 4, 3, 1), (2, 4, 2, 1),
                 (2, 4, 4, 1), (2, 2, 4, 1), (2, 4, 3, 0), (4, 4, 2, 1), (4, 4, 4, 1),
                 (8, 4, 3, 1))
GP_BICYCLE_TEAMS = ((1, 4, 1, 1), (1, 4, 3, 1), (1, 4, 4, 1), (2, 4, 3, 1), (2, 4, 2, 1),
                    (2, 4, 4, 1), (2, 2, 4, 1), (2, 4, 3, 0), (4, 4, 2, 1), (4, 4, 4, 1),
                    (8, 4, 4, 1))
KEYS = ("team", "rw", "min_blocks", "bulk")
ATOL = 2e-5  # tests/test_pallas_vde.py's tolerance of the sweep
VARIANTS = {"pacejka": ("PACEJKA", PACEJKA_TEAMS, pacejka_inputs),
            "gp_bicycle": ("GP_BICYCLE", GP_BICYCLE_TEAMS, gp_bicycle_inputs)}


def team_defines(team, rw, min_blocks, bulk, model):
    return (f"{model}_ROW_TEAM={team}", f"{model}_ROW_WARPS={rw}",
            f"{model}_MIN_BLOCKS={min_blocks}", f"VDE_BULK_STORE={bulk}")


def vde_variants(kind, B=16384, N=30, dt=0.05, small=4096):
    """One row per variant of the functor ``kind``'s traits: its resources,
    geometry, blocks and warps per SM, error, bits, and times (warm and
    cold at ``B``, warm at ``small``)."""
    model, variants, inputs = VARIANTS[kind]
    dyn, (xs, us, ps) = inputs(B, N)
    with ThreadPoolExecutor(len(variants)) as pool:
        list(pool.map(lambda v: _build.build_all((dyn.cuda_source,),
                                                 team_defines(*v, model)), variants))
    want = vde_plain(dyn, dt, 1, xs, us, ps)
    xs_s, us_s, ps_s = xs[:small], us[:small], ps[:small]
    rows, first = {}, None
    for v in variants:
        vde = make_vde(dyn, dt, N, 7, 2, ps.shape[1], device="cuda")
        vde.defines = team_defines(*v, model)
        got = vde(xs, us, ps)
        first = got if first is None else first
        geo = vde.geometry(B)
        row = rows["_".join(f"{k}{n}" for k, n in zip(KEYS, v))] = _build.functor_resources(
            dyn.cuda_source, "vde_kernel", dyn.cuda_functor, vde.defines) | dict(
            zip(KEYS, v)) | {
            "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
            "bits_as_default": all(torch.equal(g, f) for g, f in zip(got, first)),
            "ms": graph_ms(lambda: vde(xs, us, ps)),
            "cold_ms": graph_ms(lambda: vde(xs, us, ps), cold=True),
            f"b{small}_ms": graph_ms(lambda: vde(xs_s, us_s, ps_s)),
            "geometry": geo._asdict(), "blocks_per_sm": vde.occupancy(B)}
        row["warps_per_sm"] = row["blocks_per_sm"] * geo.threads // 32
        print(f"{kind} {v}: {row['ms']:.5f} ms warm, {row['cold_ms']:.5f} cold, "
              f"{row[f'b{small}_ms']:.5f} at B={small}; {row['registers']} registers, "
              f"{row['spill_stores']} / {row['spill_loads']} B spilled, "
              f"{row['warps_per_sm']} warps per SM; max|err| {row['max_abs_err']:.3e}",
              flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result to this JSON file")
    ap.add_argument("--only", default="pacejka,gp_bicycle",
                    help="the functors to sweep, comma-separated")
    args = ap.parse_args(argv)
    require_cuda("cuda")
    res = {"device": card()}
    with tf32(False):
        for kind in args.only.split(","):
            res[f"vde_{kind}"] = vde_variants(kind)
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    far = [f"{k} {v}" for k, rows in res.items() if k != "device"
           for v, r in rows.items() if not r["max_abs_err"] <= ATOL]
    if far:
        raise SystemExit(f"further than {ATOL} from vde_plain: {', '.join(far)}")


if __name__ == "__main__":
    main()
