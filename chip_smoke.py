"""Drive the PyTorch/CUDA port (``ad_mpc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Phases, each of which must pass:

1. build every CUDA source of ``ad_mpc_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together) and print the card and the build time;
2. kernel phase VDE: the fused RK4 + sensitivity kernel at c2 shapes
   (B=16384, N=30) with the bicycle at switch 1 and 0.3, held against its
   plain PyTorch version on the card at atol 2e-5;
3. kernel phase LQ: the fused interior-point QP kernel on the QPs of a c2
   tick (B=16384, N=30, 12 iterations), held against the plain batched IPM
   at atol 3e-4 / rtol 1e-3 on dx and du in every scenario; then on random
   bicycle-bounded problems (B=16384, N=30) and a ragged unit-box case at
   N=10. In every case each scenario is held to the float64 plain solution
   with an allowance from that scenario's own float32 spread (``lq_case``);
4. slice phase: the c2 fleet tick (``fleet.build_fleet``) at B=1024 and
   16384, 5 warm-up and 20 timed ticks, with each kernel launched exactly
   once per tick, the c2 quality gates, and RTI-vs-converged u0.

It then prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
...}`` line. Any failure exits non-zero before the ``ok`` line. No JAX is
imported. ``--out`` also writes every measurement as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12  # FP32 outside the tensor cores, same sheet
BICYCLE_DYN_FLOPS = 90  # hand count of the blended bicycle f(x, u, p)
WARMUP, TICKS = 5, 20
SPREAD_RUNS = 8  # perturbed float32 runs of the plain LQ version (lq_case)
SPREAD_FACTOR = 4.0


def vde_flops_per_stage(nx, nu, dyn_flops):
    """Operations of one stage of the sweep, by the JAX package's hand count
    (``bench.py:532-541``): RK4 = 4 dynamics evaluations + 14 nx for the
    combination, and the sweep = the primal plus nx+nu tangent passes at
    twice the primal each. A fused multiply-add counts as two."""
    rk4 = 4 * dyn_flops + 14 * nx
    return rk4 * (1 + 2 * (nx + nu))


def lq_flops_per_stage_iter(nx, nu):
    """Operations of one stage of one IPM iteration, by the same hand count:
    the Riccati step's cubic terms plus 16 per variable for the cones."""
    riccati = 3 * nx**3 + 4 * nx**2 * nu + 2 * nx * nu**2 + nu**3
    return riccati + 16 * (nx + nu)


def bound_ms(n_bytes, n_flops):
    """Least time on an H100 SXM: the larger of bytes over the memory rate
    and operations over the FP32 rate. Returns (ms, "bytes"|"operations")."""
    t_mem, t_ops = n_bytes / H100_BYTES_PER_S, n_flops / H100_FP32_FLOP_PER_S
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_ms(torch, fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(got, want, atol, rtol=0.0):
    """(max |got - want|, whether |got - want| <= atol + rtol |want| holds)."""
    d = (got - want).abs()
    ok = bool((d <= atol + rtol * want.abs()).all()) and bool(got.isfinite().all())
    return float(d.max()), ok


def phase_vde(torch, np, out):
    from ad_mpc_tpu_torch import fleet
    from ad_mpc_tpu_torch.ops.cuda_vde import make_vde, vde_plain
    from ad_mpc_tpu_torch.testing import random_traj

    B, N, nx, nu, dt = 16384, 30, 7, 2, 0.05
    dyn = fleet.dynamic_bicycle
    vde = make_vde(dyn, dt, N, nx, nu, 1, device="cuda")
    xs, us = random_traj(np.random.default_rng(3), B, N, nx, nu)
    xs, us = torch.as_tensor(xs).cuda(), torch.as_tensor(us).cuda()
    rows = {}
    for switch in (1.0, 0.3):
        ps = torch.full((B, 1), switch, device="cuda")
        got = vde(xs, us, ps)
        want = vde_plain(dyn, dt, 1, xs, us, ps)
        torch.cuda.synchronize()
        errs = [max_err(g, w, 2e-5) for g, w in zip(got, want)]
        err = max(e for e, _ in errs)
        check(all(ok for _, ok in errs),
              f"VDE kernel disagrees with its plain version at switch "
              f"{switch}: max |err| {err:.3e} > 2e-5")
        rows[switch] = {
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: vde(xs, us, ps), 50),
            "plain_ms": time_ms(
                torch, lambda: vde_plain(dyn, dt, 1, xs, us, ps), 3),
        }
        print(f"VDE switch={switch}: max|err| {err:.3e}, kernel "
              f"{rows[switch]['ms']:.4f} ms, plain {rows[switch]['plain_ms']:.3f}"
              f" ms, launches (comparison instance) {vde.launches}")
    n_bytes = 4 * (xs.numel() + us.numel() + B + B * N * (nx * nx + nx * nu + nx))
    n_flops = B * N * vde_flops_per_stage(nx, nu, BICYCLE_DYN_FLOPS)
    bms, by = bound_ms(n_bytes, n_flops)
    print(f"VDE bound at B={B}: {n_bytes / 1e6:.1f} MB, {n_flops / 1e9:.2f} "
          f"GFLOP -> {bms:.4f} ms ({by})")
    out["vde"] = {"cases": rows, "bytes": n_bytes, "flops": n_flops,
                  "bound_ms": bms, "bound_by": by}
    return rows[1.0] | {"bound_ms": bms, "bound_by": by, "max_abs_err": max(
        rows[s]["max_abs_err"] for s in (1.0, 0.3))}


def lq_case(torch, qp, args, strict):
    """Hold the LQ kernel against its plain version on one batch, scenario
    by scenario, at atol 3e-4 / rtol 1e-3 on dx and du.

    Where a problem is ill-conditioned, 12 float32 IPM iterations are not
    reproducible between two correct implementations: the fraction-to-
    boundary step is a min over ratios, so rounding moves the path. The
    float64 run of the plain version is the exact answer, and each scenario
    b gets an allowance from its own float32 spread s_b: the largest
    max |m - f64| over float32 runs m of the plain version, on the inputs
    and on ``SPREAD_RUNS`` copies perturbed by about one ulp. Every scenario
    must satisfy
        max (|kernel - f64| - (atol + rtol |f64|)) <= SPREAD_FACTOR * s_b,
    so a well-conditioned scenario (s_b ~ 1e-6) is held to the tolerance.
    ``factor`` is the least factor that passes. ``fixed_tol_misses``
    counts the scenarios that a rule with no allowance would reject: off
    the float32 plain version and off the float64 answer where the float32
    plain version hits it. ``control_*`` are the same two numbers for the
    plain version run on the CPU, a correct float32 implementation by
    construction. ``strict`` (the main path's QPs) also
    asks every scenario to agree with the float32 plain version. Every
    output is finite, alpha lies in [0, 1], and a second launch gives the
    same bits.
    """
    plain = lambda: qp.plain(*args)
    got, again, want = qp(*args), qp(*args), plain()
    ref64 = qp.plain(*(a.double() for a in args))
    control = qp.plain(*(a.cpu() for a in args))
    runs = [want]
    gen = torch.Generator(device=args[0].device)
    for seed in range(SPREAD_RUNS):
        gen.manual_seed(seed)
        runs.append(qp.plain(*(a * (1 + 2.0**-23 * torch.randn(
            a.shape, device=a.device, generator=gen)) for a in args)))
    torch.cuda.synchronize()
    B = args[0].shape[0]

    def excess(g, w):  # per scenario: how far dx, du lie outside tolerance of w
        return torch.stack([
            ((a.double().to(b.device) - b.double()).abs()
             - (3e-4 + 1e-3 * b.double().abs())).flatten(1).amax(1)
            for a, b in zip(g[:2], w[:2])]).amax(0)

    spread = torch.stack([torch.stack([
        (a.double() - b.double()).abs().flatten(1).amax(1)
        for a, b in zip(m[:2], ref64[:2])]).amax(0) for m in runs]).amax(0)

    def factor(g):
        e = excess(g, ref64).to(spread.device)
        need = torch.where(e > 0, e / spread, torch.zeros_like(e))
        return float(need.amax())

    plain_hits64 = excess(want, ref64) <= 0

    def fixed_tol_misses(g):
        off = (excess(g, want) > 0) & (excess(g, ref64) > 0)
        return int((off.to(plain_hits64.device) & plain_hits64).sum())

    agree = excess(got, want) <= 0
    row = {
        "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2])),
        "agree": int(agree.sum()), "B": B,
        "kernel_misses_f64": int((excess(got, ref64) > 0).sum()),
        "plain_misses_f64": int(B - plain_hits64.sum()),
        "factor": factor(got), "control_factor": factor(control),
        "fixed_tol_misses": fixed_tol_misses(got),
        "control_fixed_tol_misses": fixed_tol_misses(control),
        "deterministic": all(torch.equal(g, h) for g, h in zip(got, again)),
    }
    ok = (row["factor"] <= SPREAD_FACTOR and row["deterministic"]
          and (row["agree"] == B or not strict)
          and all(bool(g.isfinite().all()) for g in got)
          and bool(((got[2] >= 0) & (got[2] <= 1)).all()))
    return row, ok, plain


def phase_lq(torch, np, out):
    from ad_mpc_tpu_torch import fleet
    from ad_mpc_tpu_torch.ops.cuda_lq import make_lq_solver
    from ad_mpc_tpu_torch.testing import BOUNDS, LQ_WEIGHTS, random_lq

    # The QPs of the main path: the inputs of the third c2 tick at B=16384.
    tick, init, solver, spec = fleet.build_fleet(
        fleet.dynamic_bicycle, fleet.switch_on, device="cuda")
    captured = []
    solver.qp.register_forward_pre_hook(lambda mod, a: captured.append(a))
    carry = init(16384)
    for _ in range(3):
        carry, _ = tick(carry)
    Q, R = LQ_WEIGHTS
    rand = lambda B, N: [torch.as_tensor(a).cuda()
                         for a in random_lq(np.random.default_rng(5), B, N, 7, 2)]
    cases = {
        # name: (solver, inputs, strict)
        "c2_tick": (solver.qp, captured[-1], True),
        "random_N30": (make_lq_solver(30, 7, 2, Q, R, 1e-3 * Q,
                                      *spec.bound_dicts(), iters=12),
                       rand(16384, 30), False),
        "random_N10_unit": (make_lq_solver(10, 7, 2, Q, R, 1e-3 * Q,
                                           *BOUNDS["unit"](7, 2), iters=12),
                            rand(1000, 10), False),
    }
    rows = {}
    for name, (qp, args, strict) in cases.items():
        row, ok, plain = lq_case(torch, qp, args, strict)
        check(ok, f"LQ kernel disagrees with its plain version ({name}): {row}")
        B, N = args[0].shape[:2]
        n_bytes = 4 * (sum(a.numel() for a in args) + B * ((N + 1) * 7 + N * 2 + 1))
        n_flops = B * N * qp.iters * lq_flops_per_stage_iter(7, 2)
        bms, by = bound_ms(n_bytes, n_flops)
        row |= {"N": N, "ms": time_ms(torch, lambda: qp(*args), 10),
                "plain_ms": time_ms(torch, plain, 2), "bytes": n_bytes,
                "flops": n_flops, "bound_ms": bms, "bound_by": by}
        rows[name] = row
        print(f"LQ {name} B={B} N={N}: {row['agree']}/{B} scenarios agree "
              f"(max|err| {row['max_abs_err']:.3e}); outside tolerance of the "
              f"float64 solution: kernel {row['kernel_misses_f64']}, plain "
              f"{row['plain_misses_f64']}; spread factor {row['factor']:.3f} (limit "
              f"{SPREAD_FACTOR}; plain on the CPU {row['control_factor']:.3f}); "
              f"fixed-tolerance misses {row['fixed_tol_misses']} (plain on the "
              f"CPU {row['control_fixed_tol_misses']}); "
              f"deterministic {row['deterministic']}; kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.3f} ms, bound {bms:.4f} ms ({by}: "
              f"{n_bytes / 1e6:.1f} MB, {n_flops / 1e9:.2f} GFLOP)")
    out["lq"] = rows
    return rows["c2_tick"]


def phase_slice(torch, out, card):
    from ad_mpc_tpu_torch import fleet

    rows, carry_1024 = {}, None
    for B in (1024, 16384):
        tick, init, solver, _ = fleet.build_fleet(
            fleet.dynamic_bicycle, fleet.switch_on, n_nodes=30, qp_iters=12,
            sqp_iters=1, device="cuda")
        solver.vde.launches = solver.qp.launches = 0
        row, carry = fleet.run_config(tick, init, B, ticks=TICKS, warmup=WARMUP)
        launches = {"vde": solver.vde.launches, "lq_ipm": solver.qp.launches}
        row["launches"] = launches
        for k, n in launches.items():
            check(n == WARMUP + TICKS,
                  f"{k} launched {n} times in {WARMUP + TICKS} ticks at B={B}")
        bad = fleet.gate_failures(row)
        check(not bad, f"c2 gates failed at B={B}: "
              + ", ".join(f"{k}={row[k]:.3e}" for k in bad))
        rows[B] = row
        if B == 1024:
            carry_1024 = carry
        print(f"c2 B={B}: {row['solves_per_s']:.1f} solves/s "
              f"({row['tick_ms']:.3f} ms/tick) on {card}; kkt mean "
              f"{row['kkt_mean']:.3e} max {row['kkt_max']:.3e}, lat_err "
              f"{row['lat_err_mean_m']:.4f} m, launches {launches}")
    d_u0 = fleet.rti_vs_converged(fleet.dynamic_bicycle, fleet.switch_on,
                                  carry_1024)
    lim = fleet.RTI_GATE
    check(d_u0 <= lim, f"RTI-vs-converged u0 {d_u0:.3e} > {lim}")
    print(f"RTI vs converged: max|du0| {d_u0:.3e} (gate {lim})")
    out["slice"] = {str(B): r for B, r in rows.items()}
    out["rti_vs_converged_u0"] = d_u0
    return rows[16384]["launches"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ad_mpc_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    tic = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - tic
    print(f"kernels built in {build_s:.1f} s")
    for name in _build.SOURCES:
        print(f"ptxas {name}:\n{_build.ptxas_report(name)}")

    out = {"card": card, "build_s": build_s}
    vde = phase_vde(torch, np, out)
    lq = phase_lq(torch, np, out)
    launches = phase_slice(torch, out, card)

    kernels = [
        {"name": "vde", "route": "cuda", "source": "ad_mpc_tpu_torch/csrc/vde.cu",
         "replaces": "ad_mpc_tpu/ops/pallas_vde.py:106",
         "launches": launches["vde"], "max_abs_err": vde["max_abs_err"],
         "ms": vde["ms"], "plain_ms": vde["plain_ms"],
         "bound_ms": vde["bound_ms"], "bound_by": vde["bound_by"],
         "library_ms": None},
        {"name": "lq_ipm", "route": "cuda",
         "source": "ad_mpc_tpu_torch/csrc/lq_ipm.cu",
         "replaces": "ad_mpc_tpu/ops/pallas_lq.py:485",
         "launches": launches["lq_ipm"], "max_abs_err": lq["max_abs_err"],
         "ms": lq["ms"], "plain_ms": lq["plain_ms"],
         "bound_ms": lq["bound_ms"], "bound_by": lq["bound_by"],
         "library_ms": None},
    ]
    out["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
