"""Design choices of the c4 Pacejka and c3 GP-bicycle functors of the VDE
kernel and its RK4 map on the H100, at their bench shapes (B=16384, N=30,
nx=7, nu=2).

    python -m ad_mpc_tpu_torch.experiments.bicycle_kernels [--out PATH]

``csrc/vde_bicycle.cu`` and ``csrc/vde_gp_bicycle.cu`` are built once per variant of a functor's traits, all
``nvcc`` started together: ``-D{PACEJKA,GP_BICYCLE}_TANGENTS_PER_PASS`` (9
tangents in one pass, 5 + 4 or 3 x 3) and ``..._ROW_WARPS`` (warps per
block, each with an 8,960 B output tile) for both functors. For each
functor and variant: registers and spills of its VDE and RK4 instantiations from
``ptxas``, device times of the sweep and of the RK4 map's defect by
CUDA-graph replay (``experiments.graph_ms``), the largest errors against ``vde_plain``
and ``discrete_step`` (held at 2e-5), and whether the sweep's bits are the
first variant's. The inputs are the smoke's
(``testing.pacejka_inputs``, ``testing.gp_bicycle_inputs``).
"""

from __future__ import annotations

import argparse
import json
from concurrent.futures import ThreadPoolExecutor

import torch

from ad_mpc_tpu_torch.experiments import card, graph_ms, require_cuda, tf32
from ad_mpc_tpu_torch.ops import _build
from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4, make_vde, vde_plain
from ad_mpc_tpu_torch.ops.integrators import discrete_step
from ad_mpc_tpu_torch.testing import gp_bicycle_inputs, pacejka_inputs


def _traits(model, tpp, rw):
    return (f"{model}_TANGENTS_PER_PASS={tpp}", f"{model}_ROW_WARPS={rw}")


# {functor: {label: -D defines}}; the first of each is the committed default.
TRAITS = ((9, 4), (5, 4), (3, 4), (9, 2), (5, 2))
VARIANTS = {
    "pacejka": {f"tpp{t}_rw{r}": _traits("PACEJKA", t, r) for t, r in TRAITS},
    "gp_bicycle": {f"tpp{t}_rw{r}": _traits("GP_BICYCLE", t, r) for t, r in TRAITS},
}


def variants(B=16384, N=30, dt=0.05, variants=VARIANTS):
    builds = [d for rows in variants.values() for d in rows.values()]
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda d: _build.build_all(("vde_bicycle", "vde_gp_bicycle"), d),
                      builds))
    out = {}
    for key, make in (("pacejka", pacejka_inputs),
                      ("gp_bicycle", gp_bicycle_inputs)):
        dyn, (xs, us, ps) = make(B, N)
        want = vde_plain(dyn, dt, 1, xs, us, ps)
        want_c = discrete_step(dyn, dt, 1, xs[:, :-1], us, ps[:, None]) - xs[:, 1:]
        rows, first = {}, None
        for label, defines in variants[key].items():
            vde = make_vde(dyn, dt, N, 7, 2, ps.shape[1], device="cuda")
            rk4 = make_rk4(dyn, dt, 7, 2, ps.shape[1], device="cuda")
            vde.defines = rk4.defines = defines
            got = vde(xs, us, ps)
            first = got if first is None else first
            res = {k: _build.functor_resources(dyn.cuda_source, k,
                                                dyn.cuda_functor, defines)
                   for k in ("vde_kernel", "rk4_kernel")}
            defect = lambda: rk4.defect(xs, us, ps)
            rows[label] = {
                "defines": defines, "resources": res,
                "max_abs_err": max(float((g - w).abs().max())
                                   for g, w in zip(got, want)),
                "rk4_max_abs_err": float((defect() - want_c).abs().max()),
                "bits_as_default": all(torch.equal(g, f)
                                       for g, f in zip(got, first)),
                "ms": graph_ms(lambda: vde(xs, us, ps)),
                "rk4_defect_ms": graph_ms(defect),
            }
        out[key] = rows
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args(argv)
    require_cuda("cuda")
    with tf32(False):
        res = {"device": card(), "vde": variants()}
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)


if __name__ == "__main__":
    main()
