"""The bench of the port on the card: the rows of ``bench.py:main`` whose
paths are ported.

    python -m ad_mpc_tpu_torch.bench --out PATH

Rows: the c2 fleet tick at B=256/1024/4096/16384; c2-N40 (the reference's
N=40, tf=2 s dimensions) at B=1024/4096/16384; RTI against a converged
solve on the B=1024 fleet; the batch-1 latency row against the 20 ms
budget; the lane-chain micro (``experiments.mxu_riccati.micro``) and the
long-horizon Riccati micro (``experiments.long_horizon.micro``). Every c2
row gets the analytic operations per solve and its share of the FP32 peak,
and is held to the c2 quality gates.

Not ported, so not here: configs c3-c6, the deployment loop and the
shard-invariance row. The result goes to ``--out`` only; the last line of
standard output is a one-line summary. Exits 1 when a gate fails or a row
raises.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ad_mpc_tpu_torch import fleet
from ad_mpc_tpu_torch.experiments import card, require_cuda, tf32

H100_FP32_FLOP_PER_S = 67e12  # FP32 outside the tensor cores, H100 SXM data sheet

# The c2 quality gates of ``bench.py:473-476``, by config-name prefix.
GATES = {"c2_": fleet.GATES}

# Hand-counted operations of the continuous dynamics (``bench.py:523-529``).
DYN_FLOPS = {"c2_": 90}  # blended-tire bicycle


def _gates_for(cfg_name):
    for prefix, g in GATES.items():
        if cfg_name.startswith(prefix):
            return g
    return {}


def analytic_flops_per_solve(N, nx, nu, qp_iters, sqp_iters, dyn_flops):
    """Operations of one solve of the deployed tick (``bench.py:532-541``):
    the RK4 + VDE sweep (primal and nx+nu tangent passes at twice the
    primal each), the fixed-iteration Riccati IPM (cubic terms per stage and
    iteration) and the final KKT defect check."""
    rk4 = 4 * dyn_flops + 14 * nx
    vde = rk4 * (1 + 2 * (nx + nu))
    riccati = 3 * nx**3 + 4 * nx**2 * nu + 2 * nx * nu**2 + nu**3
    ipm = qp_iters * N * (riccati + 16 * (nx + nu))
    return sqp_iters * (N * vde + ipm) + N * rk4


def annotate_roofline(detail):
    """Attach operations per solve, achieved GFLOP/s and the share of the
    H100's FP32 peak to every c2 row (in place)."""
    for name, row in detail["configs"].items():
        dyn = next((v for k, v in DYN_FLOPS.items() if name.startswith(k)), None)
        if dyn is None or "solves_per_s" not in row:
            continue
        N = 40 if "_N40_" in name else 30
        fl = analytic_flops_per_solve(N, 7, 2, 12, 1, dyn)
        ach = fl * row["solves_per_s"]
        row["flops_per_solve"] = fl
        row["achieved_gflops"] = ach / 1e9
        row["pct_fp32_peak"] = 100 * ach / H100_FP32_FLOP_PER_S


def gate_failures(detail):
    """Every gate exceeded and every row that raised, as text."""
    failures = []
    for cfg_name, r in detail["configs"].items():
        for key, lim in _gates_for(cfg_name).items():
            if not r[key] <= lim:
                failures.append(f"{cfg_name}.{key}={r[key]:.3e}>{lim}")
    d_u0 = detail.get("rti_vs_converged_u0")
    if d_u0 is not None and not d_u0 <= fleet.RTI_GATE:
        failures.append(f"rti_vs_converged_u0={d_u0:.3e}>{fleet.RTI_GATE}")
    for name, err in detail["errors"].items():
        failures.append(f"{name} raised: {err[:120]}")
    return failures


def run(log=lambda s: print(s, file=sys.stderr)):
    """Every ported row on the card; returns the detail dict."""
    require_cuda("cuda")
    from ad_mpc_tpu_torch.experiments import long_horizon, mxu_riccati

    detail = {"device": card(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "configs": {}, "errors": {}}

    def guarded(name, fn):
        """One row failing never zeroes the others."""
        try:
            return fn()
        except Exception as e:  # recorded, and a failure of the run
            detail["errors"][name] = f"{type(e).__name__}: {e}"[:500]
            log(f"# {name} FAILED: {type(e).__name__}: {str(e)[:200]}")
            return None

    carry = None

    def run_c2():
        nonlocal carry
        tick, init, _, _ = fleet.build_fleet(fleet.dynamic_bicycle,
                                             fleet.switch_on)
        rows = {}
        for b in (256, 1024, 4096, 16384):
            rows[b], c = fleet.run_config(tick, init, b)
            detail["configs"][f"c2_dynamic_bicycle_b{b}"] = rows[b]
            if b == 1024:
                carry = c
        log("# c2 N=30: " + " ".join(f"b{b} {r['solves_per_s']:.0f}/s"
                                     for b, r in rows.items()))

    def run_c2_n40():
        tick, init, _, _ = fleet.build_fleet(fleet.dynamic_bicycle,
                                             fleet.switch_on, n_nodes=40)
        rows = {}
        for b in (1024, 4096, 16384):
            rows[b], _ = fleet.run_config(tick, init, b)
            detail["configs"][f"c2_dynamic_bicycle_N40_b{b}"] = rows[b]
        log("# c2-N40: " + " ".join(f"b{b} {r['solves_per_s']:.0f}/s"
                                    for b, r in rows.items()))

    def run_lat():
        lat = fleet.bench_latency(fleet.dynamic_bicycle, fleet.switch_on)
        detail["latency_ms"] = lat
        log(f"# latency: compute p50={lat['p50_compute']:.3f} ms "
            f"p99={lat['p99_compute']:.3f} ms | blocking p50="
            f"{lat['p50_blocking']:.3f} ms | floor "
            f"{lat['host_link_floor_p50']:.3f} ms | budget 20 ms")
        if lat["p99_compute"] > lat["budget"]:
            detail.setdefault("latency_warnings", []).append(
                f"compute p99 {lat['p99_compute']:.2f} ms over budget")

    with tf32(False):
        guarded("c2_dynamic_bicycle", run_c2)
        guarded("c2_n40", run_c2_n40)
        if carry is not None:
            d_u0 = guarded("rti_vs_converged", lambda: fleet.rti_vs_converged(
                fleet.dynamic_bicycle, fleet.switch_on, carry))
            if d_u0 is not None:
                detail["rti_vs_converged_u0"] = d_u0
        guarded("latency", run_lat)
        detail["mxu_riccati_micro"] = guarded("mxu_riccati", mxu_riccati.micro)
        detail["long_horizon_riccati"] = guarded("long_horizon_riccati",
                                                 long_horizon.micro)
    annotate_roofline(detail)
    failures = gate_failures(detail)
    detail["quality_gates"] = {"pass": not failures, "failures": failures,
                               "gates": GATES, "rti_gate": fleet.RTI_GATE}
    return detail


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="write the result to this JSON file")
    args = ap.parse_args(argv)
    detail = run()
    with open(args.out, "w") as fh:
        json.dump(detail, fh, indent=1)
    failures = detail["quality_gates"]["failures"]
    if failures:
        print("# QUALITY GATE FAILURES: " + "; ".join(failures), file=sys.stderr)
    best = max((r["solves_per_s"] for k, r in detail["configs"].items()
                if k.startswith("c2_") and "_N40_" not in k), default=0.0)
    print(json.dumps({"metric": "mpc_solves_per_s", "value": best,
                      "unit": "solves/s", "device": detail["device"],
                      "gates_pass": not failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
