"""The bench of the port on the card: the rows of ``bench.py:main`` whose
paths are ported.

    python -m ad_mpc_tpu_torch.bench --out PATH

Rows: the c2 fleet tick at B=256/1024/4096/16384; c2-N40 (the reference's
N=40, tf=2 s dimensions) at B=1024/4096/16384; RTI against a converged
solve on the B=1024 fleet; the c3 GP-augmented bicycle
(``fleet.make_gp_bicycle``: 32 points, 4 features, 2 outputs) at
B=256/4096/16384; the c4 Pacejka friction/topography sweep
(``fleet.make_pacejka``) at B=4096 with 45 warm-up and 10 timed ticks, and
its RTI row on that fleet; the c5 quadrotor fleet
(``experiments.quad_fleet``: nx=13, nu=4, N=10, two Gauss-Newton
iterations) at B=256/1024/4096/16384 with 20 warm-up ticks, and its RTI
row on the B=256 fleet; the c6 GP-augmented quadrotor
(``quad_fleet.make_quad_gp_ensemble``: 32 points, 3 body-frame velocity
features, 3 outputs) on the same ladder with its RTI row, and the
c6-fitted rows at B=4096/16384 with the fitted ``gp_flagship_c1`` model
(``quad_fleet.fitted_ensemble``: 60 points); the batch-1 latency row
against the 20 ms budget;
the lane-chain micro (``experiments.mxu_riccati.micro``) and the
long-horizon Riccati micro (``experiments.long_horizon.micro``); the
single-vehicle AD path: ``ad_closed_loop`` (20 s on the oval at N=40:
tracking RMSE, solve p50/p99) and the deployment loop at 50 Hz
(``deployment_loop_50hz``, ``…_pipelined``, ``deployment_aggr_nolagcomp``
and ``deployment_aggr_lagcomp``, as ``bench.py:884-915`` runs them, and the
aggressive pair again with each result held one tick,
``deployment_aggr_*_delay1``: the age of the JAX package's rows). Every
fleet row gets the analytic operations per solve and its share of the FP32
peak, and is held to its config's quality gates; the AD rows to their
tracking-RMSE gates (``AD_GATES``). The delayed pair's comparison
(:func:`lag_comp_ab`, ``aggr_ab_delay1``) is reported with its verdict and
is no gate: on the H100 the two rows tie at that age too.

The shard-invariance row (``parallel.scaling.measure_shard_invariance``:
one rank's tick with its per-tick KKT reduction against the unsplit tick
at c2's B=16384, N=30) is ``shard_invariance``. The result goes to
``--out`` only; the last line of standard output is a one-line summary.
Exits 1 when a gate fails or a row raises.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ad_mpc_tpu_torch import fleet
from ad_mpc_tpu_torch.experiments import card, quad_fleet, require_cuda, tf32

H100_FP32_FLOP_PER_S = 67e12  # FP32 outside the tensor cores, H100 SXM data sheet

# The quality gates of ``bench.py:473-491``, by config-name prefix (the
# first that matches: ``c6_fitted_`` before ``c6_``), and the
# RTI-vs-converged gates of ``bench.py:493-498`` by result key.
GATES = {"c2_": fleet.CONFIG_GATES["c2"], "c3_": fleet.CONFIG_GATES["c3"],
         "c4_": fleet.CONFIG_GATES["c4"], "c5_": quad_fleet.GATES,
         "c6_fitted_": quad_fleet.FITTED_GATES, "c6_": quad_fleet.GATES}
RTI_GATES = {"rti_vs_converged_u0": fleet.RTI_GATES["c2"],
             "c4_rti_vs_converged_u0": fleet.RTI_GATES["c4"],
             "c5_rti_vs_converged_u0": quad_fleet.RTI_GATE,
             "c6_rti_vs_converged_u0": quad_fleet.RTI_GATE}

# The AD rows' tracking-RMSE gates [m]: the closed loop at
# ``tests/test_mpc_closed_loop.py:20``'s limit, the deployment rows at
# ``tests/test_runtime.py:190,233``'s; and the deployment rows' arguments
# (``bench.py:884-915``).
AD_GATES = {"ad_closed_loop": ("rmse_pos", 0.5),
            "deployment_loop_50hz": ("tracking_rmse_m", 1.0),
            "deployment_loop_50hz_pipelined": ("tracking_rmse_m", 1.0),
            "deployment_aggr_nolagcomp": ("tracking_rmse_m", 1.0),
            "deployment_aggr_lagcomp": ("tracking_rmse_m", 1.0),
            "deployment_aggr_nolagcomp_delay1": ("tracking_rmse_m", 1.0),
            "deployment_aggr_lagcomp_delay1": ("tracking_rmse_m", 1.0)}
DEPLOY_ROWS = {
    "deployment_loop_50hz": dict(ticks=400, base_port=49800),
    "deployment_loop_50hz_pipelined": dict(ticks=400, base_port=49804,
                                           pipelined=True),
    "deployment_aggr_nolagcomp": dict(ticks=700, base_port=49808, pipelined=True,
                                      lag_compensation=False, v_target=12.0,
                                      track_radius=15.0),
    "deployment_aggr_lagcomp": dict(ticks=700, base_port=49812, pipelined=True,
                                    lag_compensation=True, v_target=12.0,
                                    track_radius=15.0),
    # The aggressive A/B at the JAX rows' result age (two ticks at p50: a
    # 24 ms link over the 20 ms period), emulated by holding each result.
    "deployment_aggr_nolagcomp_delay1": dict(
        ticks=700, base_port=49816, pipelined=True, lag_compensation=False,
        v_target=12.0, track_radius=15.0, result_delay_ticks=1),
    "deployment_aggr_lagcomp_delay1": dict(
        ticks=700, base_port=49820, pipelined=True, lag_compensation=True,
        v_target=12.0, track_radius=15.0, result_delay_ticks=1),
}

# Hand-counted operations of the continuous dynamics (``bench.py:523-529``).
DYN_FLOPS = {"c2_": 90,  # blended-tire bicycle
             "c3_": 1100,  # + 2-dim 32-point SE GP mean
             "c4_": 170,  # Pacejka magic formula + topography
             "c5_": 150,  # entrywise quaternion quad
             "c6_": 1450}  # + 3-dim 32-point GP, body-frame rotations


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


def solve_dims(name):
    """(N, nx, nu, qp_iters, sqp_iters) of a fleet row's deployed solve.
    The reference's roofline passes one Gauss-Newton iteration for c5 and
    c6 (``bench.py:559``) though their tick runs ``QUAD_SQP_ITERS``; here
    the count is the tick's."""
    if name.startswith(("c5_", "c6_")):
        return 10, 13, 4, 18, quad_fleet.QUAD_SQP_ITERS
    return (40 if "_N40_" in name else 30), 7, 2, 12, 1


def annotate_roofline(detail):
    """Attach operations per solve, achieved GFLOP/s and the share of the
    H100's FP32 peak to every fleet row (in place)."""
    for name, row in detail["configs"].items():
        dyn = next((v for k, v in DYN_FLOPS.items() if name.startswith(k)), None)
        if dyn is None or "solves_per_s" not in row:
            continue
        fl = analytic_flops_per_solve(*solve_dims(name), dyn)
        ach = fl * row["solves_per_s"]
        row["flops_per_solve"] = fl
        row["achieved_gflops"] = ach / 1e9
        row["pct_fp32_peak"] = 100 * ach / H100_FP32_FLOP_PER_S


def lag_comp_ab(rows, sfx="_delay1"):
    """The aggressive A/B of the deployment rows ``deployment_aggr_*{sfx}``
    in ``rows``: each row's RMSE, result age at p50 and unsafe ticks, and
    whether lag compensation beat none (the JAX package's result, 2.780
    against 0.160 m behind its 24 ms link). A reported verdict, not a gate
    (ROADMAP Queue C 2)."""
    ab = {k: {f: rows[f"deployment_aggr_{k}{sfx}"].get(f) for f in (
        "tracking_rmse_m", "result_age_p50_ticks", "result_age_max_ticks",
        "n_unsafe_ticks")} for k in ("lagcomp", "nolagcomp")}
    ab["reproduced"] = (ab["lagcomp"]["tracking_rmse_m"]
                        < ab["nolagcomp"]["tracking_rmse_m"])
    return ab


def gate_failures(detail):
    """Every gate exceeded and every row that raised, as text."""
    failures = []
    for cfg_name, r in detail["configs"].items():
        for key, lim in _gates_for(cfg_name).items():
            if not r[key] <= lim:
                failures.append(f"{cfg_name}.{key}={r[key]:.3e}>{lim}")
    for key, lim in RTI_GATES.items():
        d_u0 = detail.get(key)
        if d_u0 is not None and not d_u0 <= lim:
            failures.append(f"{key}={d_u0:.3e}>{lim}")
    for key, (metric, lim) in AD_GATES.items():
        row = detail.get(key)
        if row is not None and not row[metric] <= lim:
            failures.append(f"{key}.{metric}={row[metric]:.3e}>{lim}")
    for name, err in detail["errors"].items():
        failures.append(f"{name} raised: {err[:120]}")
    return failures


def run(log=lambda s: print(s, file=sys.stderr)):
    """Every ported row on the card; returns the detail dict."""
    require_cuda("cuda")
    from ad_mpc_tpu_torch.experiments import long_horizon, mxu_riccati
    from ad_mpc_tpu_torch.parallel import scaling

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

    def run_c3():
        tick, init, _, _ = fleet.build_fleet(fleet.make_gp_bicycle(),
                                             fleet.switch_on)
        rows = {}
        for b in (256, 4096, 16384):
            rows[b], _ = fleet.run_config(tick, init, b)
            detail["configs"][f"c3_gp_bicycle_b{b}"] = rows[b]
        log("# c3 GP bicycle N=30: " + " ".join(
            f"b{b} {r['solves_per_s']:.0f}/s" for b, r in rows.items()))

    def run_c4():
        dyn, p_of, v_cap = fleet.make_pacejka()
        tick, init, _, _ = fleet.build_fleet(dyn, p_of, v_cap=v_cap)
        row, carry_p = fleet.run_config(tick, init, 4096, ticks=fleet.C4_TICKS,
                                        warmup=fleet.C4_WARMUP)
        detail["configs"]["c4_pacejka_b4096"] = row
        detail["c4_rti_vs_converged_u0"] = fleet.rti_vs_converged(
            dyn, p_of, carry_p)
        log(f"# c4 Pacejka N=30: b4096 {row['solves_per_s']:.0f}/s, RTI vs "
            f"converged {detail['c4_rti_vs_converged_u0']:.2e}")

    def run_c5():
        tick, init, _, _ = quad_fleet.build_quad_fleet()
        rows, carry_q = {}, None
        for b in (256, 1024, 4096, 16384):
            rows[b], c = fleet.run_config(tick, init, b, warmup=20)
            detail["configs"][f"c5_quad_b{b}"] = rows[b]
            if b == 256:
                carry_q = c
        log("# c5 quad N=10: " + " ".join(f"b{b} {r['solves_per_s']:.0f}/s"
                                         for b, r in rows.items()))
        detail["c5_rti_vs_converged_u0"] = quad_fleet.rti_vs_converged_quad(
            carry_q)

    def run_c6():
        ens = quad_fleet.make_quad_gp_ensemble()
        tick, init, _, _ = quad_fleet.build_quad_fleet(ensemble=ens)
        rows, carry_g = {}, None
        for b in (256, 1024, 4096, 16384):
            rows[b], c = fleet.run_config(tick, init, b, warmup=20)
            detail["configs"][f"c6_gp_quad_b{b}"] = rows[b]
            if b == 256:
                carry_g = c
        log("# c6 GP-quad N=10: " + " ".join(
            f"b{b} {r['solves_per_s']:.0f}/s" for b, r in rows.items()))
        detail["c6_rti_vs_converged_u0"] = quad_fleet.rti_vs_converged_quad(
            carry_g, ensemble=ens)
        fitted = quad_fleet.fitted_ensemble()
        tick, init, _, _ = quad_fleet.build_quad_fleet(ensemble=fitted)
        for b in (4096, 16384):
            row, _ = fleet.run_config(tick, init, b, warmup=20)
            row["notes"] = ("fitted gp_flagship_c1 ensemble "
                            f"({fitted.x_train.shape[2]} pts/dim)")
            detail["configs"][f"c6_fitted_gp_quad_b{b}"] = row
            log(f"# c6-fitted b{b}: {row['solves_per_s']:.0f}/s kkt max="
                f"{row['kkt_max']:.2e}")

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

    def run_ad():
        from ad_mpc_tpu_torch.experiments.ad_closed_loop import run_closed_loop
        from ad_mpc_tpu_torch.experiments.deployment_loop import (
            run_deployment_loop)

        cl = run_closed_loop(device="cuda")
        detail["ad_closed_loop"] = {k: getattr(cl, k) for k in (
            "rmse_pos", "mean_opt_ms", "p50_opt_ms", "p99_opt_ms", "v_mean",
            "n_steps", "launches")}
        log(f"# AD closed loop N=40: rmse={cl.rmse_pos:.3f} m, solve "
            f"p50={cl.p50_opt_ms:.3f} ms p99={cl.p99_opt_ms:.3f} ms")
        if cl.p99_opt_ms > 20.0:
            detail.setdefault("latency_warnings", []).append(
                f"AD closed-loop solve p99 {cl.p99_opt_ms:.2f} ms over budget")
        for key, kw in DEPLOY_ROWS.items():
            d = detail[key] = run_deployment_loop(device="cuda", **kw)
            log(f"# {key}: rmse={d['tracking_rmse_m']:.3f} m, tick "
                f"p50={d['tick_p50_ms']:.2f} ms p99={d['tick_p99_ms']:.2f} ms, "
                f"missed {d['missed_deadlines']}/{d['ticks']}")
        ab = detail["aggr_ab_delay1"] = lag_comp_ab(detail)
        log(f"# aggressive A/B at delay 1: lag compensation "
            f"{ab['lagcomp']['tracking_rmse_m']:.4f} m, none "
            f"{ab['nolagcomp']['tracking_rmse_m']:.4f} m: JAX result "
            f"{'reproduced' if ab['reproduced'] else 'not reproduced'}")

    with tf32(False):
        guarded("c2_dynamic_bicycle", run_c2)
        guarded("c2_n40", run_c2_n40)
        if carry is not None:
            d_u0 = guarded("rti_vs_converged", lambda: fleet.rti_vs_converged(
                fleet.dynamic_bicycle, fleet.switch_on, carry))
            if d_u0 is not None:
                detail["rti_vs_converged_u0"] = d_u0
        guarded("c3_gp_bicycle", run_c3)
        guarded("c4_pacejka", run_c4)
        guarded("c5_quad", run_c5)
        guarded("c6_gp_quad", run_c6)
        guarded("latency", run_lat)
        guarded("ad_path", run_ad)
        detail["shard_invariance"] = guarded(
            "shard_invariance", scaling.measure_shard_invariance)
        detail["mxu_riccati_micro"] = guarded("mxu_riccati", mxu_riccati.micro)
        detail["long_horizon_riccati"] = guarded("long_horizon_riccati",
                                                 long_horizon.micro)
    annotate_roofline(detail)
    failures = gate_failures(detail)
    detail["quality_gates"] = {"pass": not failures, "failures": failures,
                               "gates": GATES, "rti_gates": RTI_GATES,
                               "ad_gates": AD_GATES}
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
