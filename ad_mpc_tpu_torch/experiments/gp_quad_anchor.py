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
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ad_mpc_tpu_torch.experiments import card, require_cuda
from ad_mpc_tpu_torch.experiments.quad_fleet import fitted_ensemble
from ad_mpc_tpu_torch.models.gp_quad import GPQuadDynamics
from ad_mpc_tpu_torch.ops import _build
from ad_mpc_tpu_torch.ops.cuda_vde import make_vde, vde_plain
from ad_mpc_tpu_torch.testing import (
    SPREAD_RUNS, perturbed, quad_traj, table_perturbed)

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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args(argv)
    require_cuda("cuda")
    text = json.dumps({"device": card(), "batch": args.batch,
                       "ratios": measure(args.batch)}, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)


if __name__ == "__main__":
    main()
