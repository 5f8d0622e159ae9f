"""How the fitted GP quad's float32 sweep is held to its float64 plain
version (``testing.f64_anchored``), measured on the card at c6-fitted's
shape (B=16384, N=10, the 60-point ``gp_flagship_c1``).

    python -m ad_mpc_tpu_torch.experiments.gp_quad_anchor [--batch B] [--out PATH]

For A, Bm and c of the VDE kernel it reports the largest ratio
(|x - f64| - 3e-5) / s, per row of A and Bm and per entry of c, and per
entry position over the batch and stages. s is the float32 spread of the
plain version there: its largest distance from the float64 plain answer
over its run on the inputs and 8 runs on perturbed copies, (a) of the
inputs alone (``testing.perturbed``), (b) of the inputs and of the GP
table (``testing.table_perturbed``), with the seeds ``chip_smoke.py``
uses. x is the kernel's answer and, as a control, the plain version's own
run on the inputs, held against the spread of its 8 perturbed runs. A
spread under which the control exceeds ``testing.SPREAD_FACTOR`` cannot
judge the kernel.

    python -m ad_mpc_tpu_torch.experiments.gp_quad_anchor --select [--out PATH]

The select functor (``GPQuadSelectDyn``, ``gp_flagship_c2``: two clusters
of 60 points, the nearest centroid at every evaluation) on the draws of
``chip_smoke.py``'s phase 12 (``testing.margin_quad_traj``, B=16384,
N=10, seeds 13 and 14) and on the drag-free draws that were also filtered
by the drag case's tie margins, where one row once lay 7.02 spreads out:
the same ratios for the VDE sweep (A, Bm by rows, c by entries) and the
RK4 map's defect (by entries) against three sets of float32 runs of the
plain version, each on the inputs and on 8 perturbed copies of the inputs
and of the table: ``torch.sum``'s order (``pairwise``, the check's runs),
each GP mean summed in the order of the points as the kernel sums it
(``testing.sequential_sums``, ``sequential``), and both (``both``); for
the drag case also the runs the check took before ``table_perturbed``
kept the drag (``drag_dropped``). For each set, the kernel's largest ratio
and the control's (the other order's run on the inputs); and for the rows
of largest ratio under ``pairwise``: their scenario, stage and row, the
kernel's, the two orders' and their spreads' distances from the float64
answer, and the kernel's distance from the sequential order's run.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ad_mpc_tpu_torch.experiments import card, require_cuda
from ad_mpc_tpu_torch.experiments.quad_fleet import (
    fitted_ensemble, fitted_ensemble_c2, fitted_rdrv_d, make_quad_gp_ensemble)
from ad_mpc_tpu_torch.models.gp_quad import GPQuadDynamics, GPQuadSelectDynamics
from ad_mpc_tpu_torch.ops import _build
from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4, make_vde, vde_plain
from ad_mpc_tpu_torch.ops.integrators import discrete_step
from ad_mpc_tpu_torch.testing import (
    SPREAD_FACTOR, SPREAD_RUNS, margin_quad_traj, perturbed, quad_traj,
    sequential_sums, table_perturbed)

ATOL = 3e-5
OUTPUTS = ("A", "Bm", "c")


def _plain(dyn, xs, us, ps, chunk=2048):
    """``vde_plain`` in chunks of ``chunk`` scenarios."""
    outs = [vde_plain(dyn, 0.1, 1, *(t[i:i + chunk] for t in (xs, us, ps)))
            for i in range(0, xs.shape[0], chunk)]
    return tuple(torch.cat(o) for o in zip(*outs))


def _ratio(err, spread):
    over = (err - ATOL).clamp(min=0)
    return float(torch.where(over > 0, over / spread, torch.zeros_like(over)).max())


def ratios(got, runs, want64):
    """Per output, the largest ratio of ``got`` against the spread of
    ``runs``: by row (A, Bm) or entry (c), and by entry position."""
    res = {}
    for i, name in enumerate(OUTPUTS):
        err = (got[i].double() - want64[i]).abs()
        spread = torch.stack([(r[i].double() - want64[i]).abs()
                              for r in runs]).amax(0)
        by_row = (lambda t: t) if name == "c" else (lambda t: t.amax(-1))
        res[name] = {"row": _ratio(by_row(err), by_row(spread)),
                     "position": _ratio(err.amax((0, 1)), spread.amax((0, 1)))}
    return res


def measure(batch=16384, N=10):
    _build.build_all(("vde_gp_quad",))
    dyn = GPQuadDynamics(fitted_ensemble())
    xs, us = (torch.as_tensor(a, device="cuda")
              for a in quad_traj(np.random.default_rng(13), batch, N))
    args = (xs, us, torch.zeros((batch, 0), device="cuda"))
    got = make_vde(dyn, 0.1, N, 13, 4, 0, device="cuda")(*args)
    want64 = _plain(dyn, *(a.double() for a in args))
    plain = _plain(dyn, *args)
    spreads = {
        "inputs": [_plain(dyn, *perturbed(args, s)) for s in range(SPREAD_RUNS)],
        "inputs_and_table": [_plain(table_perturbed(dyn, s), *perturbed(args, s))
                             for s in range(SPREAD_RUNS)],
    }
    return {name: {"kernel": ratios(got, [plain] + runs, want64),
                   "control": ratios(plain, runs, want64)}
            for name, runs in spreads.items()}


# The select draws: (seed, the select dynamics whose tie margins filter
# them, the dynamics held). "call7" are the drag-free draws filtered by
# the drag case's margins too.
SELECT_DRAWS = {"smoke_vde": (13, ("c2", "two"), "c2"),
                "smoke_rk4": (14, ("c2", "two"), "c2"),
                "call7_vde": (13, ("c2", "two", "c2_drag"), "c2"),
                "call7_rk4": (14, ("c2", "two", "c2_drag"), "c2"),
                "drag_vde": (13, ("c2_drag",), "c2_drag")}
WORST_ROWS = 4


def _select_outputs(dyn, xs, us, ps, chunk=4096):
    """The sweep (A, Bm, c) and the RK4 defect of the plain version of
    ``dyn``, in chunks of ``chunk`` scenarios."""
    parts = []
    for i in range(0, xs.shape[0], chunk):
        x, u, p = (t[i:i + chunk] for t in (xs, us, ps))
        parts.append((*vde_plain(dyn, 0.1, 1, x, u, p),
                      discrete_step(dyn, 0.1, 1, x[:, :-1], u, p[:, None]) - x[:, 1:]))
    return tuple(torch.cat(o) for o in zip(*parts))


def _by_rows(t, i):
    """Outputs 0 and 1 (A, Bm) by rows, c and the defect by entries."""
    return t.amax(-1) if i < 2 else t


def select_draw(B=16384, N=10):
    """The select functor held to its float64 plain version under each set
    of float32 runs (the module's docstring)."""
    _build.build_all(("vde_gp_quad_select",))
    c2, D = fitted_ensemble_c2(), fitted_rdrv_d()
    dyns = {"c2": GPQuadSelectDynamics(c2),
            "two": GPQuadSelectDynamics(make_quad_gp_ensemble(clusters=2)),
            "c2_drag": GPQuadSelectDynamics(c2, rdrv_d=D)}
    res = {}
    for name, (seed, filt, held) in SELECT_DRAWS.items():
        dyn = dyns[held]
        xs, us = (torch.as_tensor(a, device="cuda") for a in margin_quad_traj(
            np.random.default_rng(seed), B, N, [dyns[k] for k in filt], 0.1,
            device="cuda"))
        ps = torch.zeros((B, 0), device="cuda")
        args = (xs, us, ps)
        vde = make_vde(dyn, 0.1, N, 13, 4, 0, device="cuda")
        got = (*vde(*args), make_rk4(dyn, 0.1, 13, 4, 0, device="cuda").defect(*args))
        want64 = _select_outputs(dyn, *(a.double() for a in args))
        runs = {"pairwise": [_select_outputs(dyn, *args)] + [
                    _select_outputs(table_perturbed(dyn, s), *perturbed(args, s))
                    for s in range(SPREAD_RUNS)],
                "sequential": [_select_outputs(sequential_sums(dyn), *args)] + [
                    _select_outputs(sequential_sums(table_perturbed(dyn, s)),
                                    *perturbed(args, s))
                    for s in range(SPREAD_RUNS)]}
        runs["both"] = runs["pairwise"] + runs["sequential"]
        if held == "c2_drag":
            runs["drag_dropped"] = [runs["pairwise"][0]] + [
                _select_outputs(GPQuadSelectDynamics(table_perturbed(dyn, s).ensemble),
                                *perturbed(args, s)) for s in range(SPREAD_RUNS)]
        row = res[name] = {"seed": seed, "filtered_by": filt, "held": held}
        spreads = {}
        for kind, rs in runs.items():
            ratio, control = [], []
            spreads[kind] = []
            for i, w64 in enumerate(want64):
                spread = _by_rows(torch.stack(
                    [(r[i].double() - w64).abs() for r in rs]).amax(0), i)
                spreads[kind].append(spread)
                for who, out in ((ratio, got[i]), (control, (
                        runs["sequential"] if kind == "pairwise" else
                        runs["pairwise"])[0][i])):
                    err = _by_rows((out.double() - w64).abs(), i)
                    over = (err - ATOL).clamp(min=0)
                    who.append(float(torch.where(over > 0, over / spread,
                                                 torch.zeros_like(over)).max()))
            row[kind] = {"kernel": dict(zip(("A", "Bm", "c", "defect"), ratio)),
                         "control": dict(zip(("A", "Bm", "c", "defect"), control))}
        worst = []
        for i, w64 in enumerate(want64):
            err = _by_rows((got[i].double() - w64).abs(), i)
            over = (err - ATOL).clamp(min=0)
            over = torch.where(over > 0, over / spreads["pairwise"][i],
                               torch.zeros_like(over))
            flat = over.flatten()
            for j in torch.topk(flat, min(WORST_ROWS, flat.numel())).indices.tolist():
                idx = np.unravel_index(j, over.shape)
                at = lambda t: float(_by_rows(t, i)[idx])
                seq32 = runs["sequential"][0][i].double()
                worst.append({
                    "output": ("A", "Bm", "c", "defect")[i],
                    "scenario": int(idx[0]), "stage": int(idx[1]),
                    "row": int(idx[2]) if len(idx) > 2 else None,
                    "ratio_pairwise": float(flat[j]),
                    "kernel_f64": at((got[i].double() - w64).abs()),
                    "pairwise_f64": at((runs["pairwise"][0][i].double() - w64).abs()),
                    "sequential_f64": at((seq32 - w64).abs()),
                    "kernel_sequential": at((got[i].double() - seq32).abs()),
                    "kernel_pairwise": at((got[i].double()
                                           - runs["pairwise"][0][i].double()).abs()),
                    "spread_pairwise": float(spreads["pairwise"][i][idx]),
                    "spread_sequential": float(spreads["sequential"][i][idx]),
                    "sequential_own_spread": at(torch.stack(
                        [(r[i].double() - seq32).abs()
                         for r in runs["sequential"][1:]]).amax(0)),
                })
        row["worst"] = sorted(worst, key=lambda w: -w["ratio_pairwise"])[:2 * WORST_ROWS]
        print(name, json.dumps({k: row[k] for k in runs}), flush=True)
    return {"factor": SPREAD_FACTOR, "atol": ATOL, "draws": res}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--select", action="store_true",
                    help="measure the select functor's draws instead")
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args(argv)
    require_cuda("cuda")
    result = select_draw(args.batch) if args.select else {"ratios": measure(args.batch)}
    text = json.dumps({"device": card(), "batch": args.batch} | result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)


if __name__ == "__main__":
    main()
