"""Drive the PyTorch/CUDA port (``ad_mpc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Phases, each of which must pass:

1. build every CUDA source of ``ad_mpc_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together) and print the card and the build time;
2. kernel phase VDE: the fused RK4 + sensitivity kernel at c2 shapes
   (B=16384, N=30) with the bicycle at switch 1 and 0.3, held against its
   plain PyTorch version on the card at atol 2e-5; its device time by
   CUDA-graph replay of 20 launches (``experiments.graph_ms``, the row's
   ``ms``), beside the CUDA events' around back-to-back launches; then
   kernel phase RK4: both modes of the sweep's tangent-free RK4 entry (the
   KKT defect over B=16384, N=30, and the plant step over 16384 vehicles
   with u a strided view) held against ``integrators.discrete_step`` at
   atol 2e-5, at switch 1 and 0.3. Every kernel time is taken by graph
   replay, warm and cold (cold: 128 MB written before each launch in the
   graph, so the bytes come from HBM, not the L2, and the writes' own
   replay time subtracted);
3. kernel phase LQ: the fused interior-point QP kernel on the QPs of the
   third c2 tick at B=16384 and at B=1024 (N=30, 12 iterations), held
   against the plain batched IPM at atol 3e-4 / rtol 1e-3 on dx and du in
   every scenario; then on the QPs of a c2-N40 tick (B=16384), random
   bicycle-bounded problems (B=16384, N=30) and a ragged unit-box case at
   N=10 (timed cold too). In every case each scenario is held to the
   float64 plain solution with an allowance from that scenario's own
   float32 spread (``testing.lq_case``), and the kernel's launch geometry is
   printed (scenarios and threads per block, shared bytes per block,
   resident blocks per SM);
4. slice phase: the c2 fleet tick (``fleet.build_fleet``) at B=1024 and
   16384, 5 warm-up and 20 timed ticks, with the launches per tick of
   ``fleet.LAUNCHES_PER_TICK`` (the sweep and the QP once, the RK4 map
   twice), the c2 quality gates, and RTI-vs-converged u0;
4a. c4, the Pacejka sweep (``fleet.make_pacejka``): kernel phases VDE and
   RK4 with the ``PacejkaDyn`` functor at B=16384, N=30 (held to their
   plain versions at 2e-5 on p drawn by ``p_of`` and on the same draw at
   mu = 0.6, warm and cold, registers and spills), then the fleet at
   B=4096, 45 warm-up and 10 timed ticks, its launches per tick, the c4
   gates and RTI-vs-converged u0;
4b. c3, the GP bicycle (``fleet.make_gp_bicycle``): the same kernel phases
   with the ``GPBicycleDyn`` functor on the bench's 32-point ensemble and
   its 8-point twin, then the fleet at B=256, 4096 and 16384, 5 warm-up
   and 20 timed ticks, its launches per tick and the c3 gates;
5. the c5 quadrotor (nx=13, nu=4, N=10, p_dim=0): kernel phase VDE quad
   (B=16384, held to ``vde_plain`` at 3e-5, with registers and spills),
   kernel phase RK4 quad (both modes against ``discrete_step`` at 3e-5,
   warm and cold), kernel phase LQ 13x4 (``lq_case`` on the QPs of the
   third c5 tick at B=16384, strict, and B=1024, and on random unit-box
   problems at B=16384, 18 iterations; the two tick cases timed warm and
   cold, with the kernel's registers and spills, threads and shared bytes
   per scenario and resident scenarios per SM), then the c5 fleet
   (``experiments.quad_fleet``) at B=256, 1024, 4096 and 16384, 20 warm-up
   and 20 timed ticks, with ``quad_fleet.LAUNCHES_PER_TICK`` (two
   Gauss-Newton iterations: the sweep and the QP twice, the RK4 map
   twice), the c5 gates, and RTI-vs-converged u0 on the B=256 fleet;
5a. c6, the GP-augmented quadrotor: kernel phase VDE gp_quad (B=16384,
   N=10, p_dim=0) on the bench's synthetic 32-point ensemble, held to
   ``vde_plain`` at 3e-5, and on the fitted 60-point ``gp_flagship_c1``,
   whose float32 rounding alone moves a step by about 1e-4: each row of A
   and Bm and each entry of c held to the float64 plain version within
   3e-5 plus 4 times the float32 plain version's spread there (its largest
   distance over the inputs and 8 copies of the inputs and of the GP table
   each moved by an ulp; ``testing.f64_anchored``); warm and cold,
   registers and spills; the
   bound counted as the kernel's design needs it
   (:func:`gp_quad_vde_flops_per_stage`); kernel phase RK4 gp_quad (both
   modes, the same rules); then the c6 fleet at B=256, 1024, 4096 and
   16384 (20 + 20 ticks, launches per tick, the c6 gates, RTI-vs-converged
   u0 on the B=256 fleet) and the c6-fitted fleet at B=4096 and 16384 with
   its gates;
6. kernel phase lane chain: the lane-layout chained product (B=16384,
   nx=7, 12 links) held against its plain version and against 12 chained
   fp32 ``torch.bmm`` at 1e-5 of max |out|, a relaunch repeating its
   bits; its launch geometry (blocks, threads and shared bytes per block,
   resident blocks per SM); its device time warm and cold and that of the
   bmm chain (``library_ms``);
7. MXU micro and macro (``experiments.mxu_riccati``, each arm timed by
   CUDA-graph replay): every output finite, the lane arm's output after
   50 renormalised applications no further from its float64 counterpart
   than SPREAD_FACTOR times the fp32 bmm arm's (one application is held
   at 1e-5 in phase 5), one kernel launch captured per application and
   captured launches x replays equal to the applications reported, and
   the macro's kernel arm within the c2 gates with the tick's launches;
8. long-horizon Riccati micro (``experiments.long_horizon``, each backend
   timed by CUDA-graph replay): the associative scan within 2e-3 of the
   sequential recursion at N=30 and 128 (N=512 printed);
9. c2-N40 at B=16384: 5 + 20 ticks, the tick's launches, the c2 gates;
10. the batch-1 latency row (``fleet.bench_latency``) with the tick's
    launches: printed; over the 20 ms budget is a warning, as in
    ``bench.py``;
11. the single-vehicle AD path (``ocp.solver.SQPSolver``,
    ``control.mpc.BicycleMPC``, the closed loop and the deployment loop):
    at B=1 for N=40 (18 IPM iterations, the closed loop's) and N=20 (10,
    the deployment node's), an RTI solve through the kernels against the
    plain solver on the card (u0 within 1e-3; one launch of each kernel),
    per-stage p by the one-stage route giving the broadcast bits,
    point-reference mode (10 Gauss-Newton iterations, 6 line-search
    candidates: u0 within 1e-3, 10 sweeps, 10 QPs, 10 N + 1 RK4 launches),
    the solves' device time by graph replay; kernel phases VDE, RK4 and LQ
    on the RTI solve's inputs (2e-5; ``lq_case``, strict), warm and cold;
    then the fused controller step with every host synchronisation an
    error, the oracle instance (30 RTI re-solves, |u0 - u0_oracle| < 1e-3),
    the reference window's host time, the 20 s closed loop on the oval
    (RMSE < 0.5 m; solve p50/p99 against the 20 ms budget, over it a
    warning) and the four deployment rows of ``bench.py:884-915`` (RMSE <
    1.0 m each, tick p50/p99, missed deadlines, unsafe ticks, the link
    floor, the JAX package's RMSEs beside; the aggressive lag-compensation
    A/B printed with the age of the published commands).

Each path of phases 4, 4a, 4b, 5, 5a and 7-11 starts with its kernels' launch
counts at 0 and reads them after. The script then prints a
``{"kernels": [...]}`` line (each kernel's launches on its path, error,
times, bound and, for the VDE and RK4 rows, the registers and spills of
its functor's instantiation, matched by the functor's exact name), failing
if a kernel was not launched on its path or ran under its bound, and,
last, the ``{"ok": true, ...}`` line. Any failure exits non-zero
before the ``ok`` line. No JAX is imported. ``--out`` also writes every
measurement as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12  # FP32 outside the tensor cores, same sheet
GP_POINTS, GP_DIMS, GP_FEATS = 32, 2, 4  # c3's GP (bench.py:227)
GP_QUAD_POINTS, GP_QUAD_DIMS, GP_QUAD_FEATS = 32, 3, 3  # c6's synthetic GP
WARMUP, TICKS = 5, 20
C5_WARMUP = 20  # the c5 rows' warm-up ticks (bench.py:779)


def sweep_flops_per_stage(dyn, nx, nu, ps):
    """Operations of one stage of the VDE sweep of ``dyn``: its
    forward-mode algorithm counted from its plain version
    (``experiments.opcount``: each evaluation's primal once and its tangent
    cost per tangent, the RK4 combination and the defect)."""
    from ad_mpc_tpu_torch.experiments.opcount import dyn_counts, sweep_flops

    return sweep_flops(dyn_counts(dyn, nx, nu, ps[0].cpu()), nx, nu)


def gp_ops(n, D=GP_DIMS, d=GP_FEATS):
    """The least operations of one evaluation of c3's GP means, as
    (primal, gradient), in the form that keeps X_j sqrt(0.5) / l in the
    table. Primal: the features scaled once per output, w = z sqrt(0.5) / l
    (D d); per point and output the d differences w_k - X'_jk, their
    squared sum (2d - 1), exp of its negation, a x and the sum into the
    mean started at y_mean (3d + 2; exp as one operation); each mean added
    to its row (D). Gradient, g_k = -(sqrt(2) / l_k) sum_j a_j e_j t_jk:
    one multiply-add per point, output and feature (2d), then the scale
    once per output and feature (D d). At n=32, D=2, d=4: 906 and 520."""
    primal = D * d + n * D * (3 * d + 2) + D
    grad = n * D * 2 * d + D * d
    return primal, grad


def gp_vde_flops_per_stage(bicycle, ps, n, D=GP_DIMS, d=GP_FEATS, nx=7, nu=2):
    """The least operations of one stage of c3's sweep: the bicycle's sweep
    (:func:`sweep_flops_per_stage` of ``bicycle``), plus for each of RK4's
    4 evaluations the GP's means and gradients (:func:`gp_ops`) and their
    tangents by one contraction, 2d per tangent and output (d
    multiply-adds, the first a multiply, and the add to the row's tangent).
    At n=32: 4 x (906 + 520 + 144) = 6,280 over the bicycle's. bench.py's
    1,100 operations per evaluation (``DYN_FLOPS``) charge the GP's
    products to every tangent, which a closed-form gradient does not
    need."""
    primal, grad = gp_ops(n, D, d)
    gp = primal + grad + D * 2 * d * (nx + nu)
    return sweep_flops_per_stage(bicycle, nx, nu, ps) + 4 * gp


def gp_rk4_flops_per_row(bicycle, ps, n, D=GP_DIMS, d=GP_FEATS, nx=7, nu=2):
    """The least operations of c3's RK4 map for one row: the bicycle's
    (``opcount.rk4_flops``) plus each of the 4 evaluations' GP means
    without gradients (:func:`gp_ops`)."""
    from ad_mpc_tpu_torch.experiments.opcount import dyn_counts, rk4_flops

    primal, _ = gp_ops(n, D, d)
    return rk4_flops(dyn_counts(bicycle, nx, nu, ps[0].cpu()), nx) + 4 * primal


def quad_rotations(x, u, p):
    """The GP-quad's dynamics with each body-frame mean replaced by its
    feature, ``x_dot[7:10] += R(q) R(q)^T v``: the quad plus the float
    rotations of the residual (R, v_b = R^T v, R mu and the adds into the
    rows), for ``experiments.opcount`` to count without tangents."""
    from ad_mpc_tpu_torch.learned.lane import _rot_rows, add_rows
    from ad_mpc_tpu_torch.models.quadrotor import quad_dynamics_lane

    R = _rot_rows(x)
    v_b = [R[0][r] * x[7] + R[1][r] * x[8] + R[2][r] * x[9] for r in range(3)]
    return add_rows(quad_dynamics_lane(x, u), {
        7 + r: R[r][0] * v_b[0] + R[r][1] * v_b[1] + R[r][2] * v_b[2]
        for r in range(3)})


# The float Jacobian of the GP quad's residual r = R mu(R^T v) in (q, v)
# (``csrc/vde.cu:gp_quad_jacobian``): H = R G and dr/dv = H R^T, 9 dot
# products of 3 each (45 + 45); the 4 matrices dR/dq_i, whose 30 non-zero
# entries come from 7 scalars (2 q_i, -4 q_x, -4 q_y, -4 q_z); over those
# entries (dR/dq_i)^T v and (dR/dq_i) mu, 30 multiplies and 18 adds each
# (96); H (dR/dq_i)^T v, 4 x 3 dot products, and their adds to
# (dR/dq_i) mu (60 + 12).
GP_QUAD_JACOBIAN_OPS = 45 + 45 + 7 + 96 + 72


def gp_quad_vde_flops_per_stage(n, D=GP_QUAD_DIMS, d=GP_QUAD_FEATS, nx=13,
                                nu=4):
    """The least operations of one stage of c6's sweep, as the kernel's
    design needs them: the quad's own sweep (``experiments.opcount``), plus
    for each of RK4's 4 evaluations, in float, the rotations (R, v_b, R mu
    and the adds into the rows: :func:`quad_rotations`'s primal over the
    quad's), the GP's means and gradients (:func:`gp_ops`, less its D adds
    into a row, which R mu replaces), the residual's Jacobian in (q, v)
    (``GP_QUAD_JACOBIAN_OPS``), and its lift by one contraction of the 7
    entries per tangent and output, 7 multiplies, 6 adds and the add to
    the row's tangent. At n=32: 4 x (55 + 1,065 + 585 + 265 + 714) over the
    quad's 12,151."""
    import torch

    from ad_mpc_tpu_torch.experiments.opcount import dyn_counts
    from ad_mpc_tpu_torch.models.quadrotor import quad_dynamics_lane

    p = torch.zeros((1, 0))
    quad = lambda x, u, p: quad_dynamics_lane(x, u)
    rotations = (dyn_counts(quad_rotations, nx, nu, p[0]).primal
                 - dyn_counts(quad, nx, nu, p[0]).primal)
    primal, grad = gp_ops(n, D, d)
    lift = D * (nx + nu) * (2 * 7)
    gp = rotations + primal - D + grad + GP_QUAD_JACOBIAN_OPS + lift
    return sweep_flops_per_stage(quad, nx, nu, p) + 4 * gp


def gp_quad_rk4_flops_per_row(n, D=GP_QUAD_DIMS, d=GP_QUAD_FEATS, nx=13, nu=4):
    """The least operations of c6's RK4 map for one row: the quad's with
    the rotations (:func:`quad_rotations`) plus each of the 4 evaluations'
    GP means without gradients."""
    import torch

    from ad_mpc_tpu_torch.experiments.opcount import dyn_counts, rk4_flops

    primal, _ = gp_ops(n, D, d)
    counts = dyn_counts(quad_rotations, nx, nu, torch.zeros(0))
    return rk4_flops(counts, nx) + 4 * (primal - D)


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


def zero_launches(solver):
    """Set the launch counts of the solver's kernels to 0."""
    solver.vde.launches = solver.qp.launches = solver.rk4.launches = 0


def check_launches(per_tick, launches, ticks, where):
    """Each kernel launched ``per_tick[kernel]`` times per tick."""
    want = {k: n * ticks for k, n in per_tick.items()}
    check(launches == want,
          f"launches {launches} in {ticks} ticks {where}, expected {want}")


def max_err(got, want, atol, rtol=0.0):
    """(max |got - want|, whether |got - want| <= atol + rtol |want| holds)."""
    d = (got - want).abs()
    ok = bool((d <= atol + rtol * want.abs()).all()) and bool(got.isfinite().all())
    return float(d.max()), ok


def chunked(fn, *args, chunk=2048):
    """``fn`` over chunks of ``chunk`` scenarios, outputs concatenated: the
    float64 plain versions at B=16384 would take tens of GB at once."""
    import torch

    outs = [fn(*(a[i:i + chunk] for a in args))
            for i in range(0, args[0].shape[0], chunk)]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs)
    return tuple(torch.cat(o) for o in zip(*outs))


def anchored(key, name, got, plain, dyn, args, atol, rows):
    """Each output of ``got`` held by ``testing.f64_anchored`` (by rows
    where ``rows`` says so) against the float64 answer of the plain version
    ``plain(dyn, *args)``, with the spread of its float32 answers on
    ``args`` and on ``SPREAD_RUNS`` copies of the inputs and of the GP
    table each moved by about an ulp (``testing.perturbed``,
    ``testing.table_perturbed``); returns (max |got - float32 plain|,
    numbers for the record)."""
    from ad_mpc_tpu_torch.testing import (
        SPREAD_FACTOR, SPREAD_RUNS, f64_anchored, perturbed, table_perturbed)

    want64 = plain(dyn, *(a.double() for a in args))
    runs = [plain(dyn, *args)] + [
        plain(table_perturbed(dyn, s), *perturbed(args, s))
        for s in range(SPREAD_RUNS)]
    rec = {"f64_err": 0.0, "f32_spread": 0.0, "spread_ratio": 0.0}
    for i, (g, w64, by_rows) in enumerate(zip(got, want64, rows)):
        err, spread, ratio, ok = f64_anchored(g, [r[i] for r in runs], w64,
                                              atol, by_rows)
        check(ok, f"{key} kernel at {name}, output {i}: a "
              f"{'row' if by_rows else 'entry'} lies further from the float64 "
              f"plain version than {atol} + {SPREAD_FACTOR} x the float32 plain "
              f"version's spread there (ratio {ratio:.2f})")
        rec = {k: max(rec[k], v) for k, v in
               zip(rec, (err, spread, ratio))}
    err32 = max(float((g - w).abs().max()) for g, w in zip(got, runs[0]))
    print(f"{key} {name}: from the float64 plain version kernel "
          f"{rec['f64_err']:.3e}, float32 plain runs up to "
          f"{rec['f32_spread']:.3e}; largest (err - {atol}) / spread "
          f"{rec['spread_ratio']:.3f} (<= {SPREAD_FACTOR}); kernel vs "
          f"float32 plain {err32:.3e}")
    return err32, rec


def vde_case(torch, out, key, cases, dt, xs, us, atol, flops_per_stage=None,
             anchor=()):
    """The VDE kernel against ``vde_plain`` at ``atol`` for each case of
    ``cases`` ({name: (dynamics, ps)}), the cases named in ``anchor`` by
    :func:`anchored` instead; device time by CUDA-graph replay
    (``experiments.graph_ms``, the row's ``ms``), beside the CUDA events'
    around back-to-back launches (``events_ms``), and by graph replay with
    the inputs out of L2 (``cold_ms``); registers and spills of the first
    case's functor.
    Returns the kernels-line numbers (times of the first case). The bound
    counts ``flops_per_stage``, by default :func:`sweep_flops_per_stage` of
    the first case."""
    from ad_mpc_tpu_torch.experiments import graph_ms
    from ad_mpc_tpu_torch.ops import _build
    from ad_mpc_tpu_torch.ops.cuda_vde import make_vde, vde_plain

    B, N, nx = xs.shape[0], xs.shape[1] - 1, xs.shape[2]
    nu = us.shape[-1]
    rows = {}
    for name, (dyn, ps) in cases.items():
        vde = make_vde(dyn, dt, N, nx, nu, ps.shape[-1], device="cuda")
        got = vde(xs, us, ps)
        plain = lambda d, *a: chunked(lambda *c: vde_plain(d, dt, 1, *c), *a)
        extra = {}
        if name in anchor:
            err, extra = anchored(key, name, got, plain, dyn, (xs, us, ps),
                                  atol, (True, True, False))
        else:
            want = plain(dyn, xs, us, ps)
            errs = [max_err(g, w, atol) for g, w in zip(got, want)]
            err = max(e for e, _ in errs)
            check(all(ok for _, ok in errs),
                  f"{key} kernel disagrees with its plain version at {name}: "
                  f"max |err| {err:.3e} > {atol}")
        row = rows[name] = extra | {
            "max_abs_err": err,
            "ms": graph_ms(lambda: vde(xs, us, ps)),
            "events_ms": time_ms(torch, lambda: vde(xs, us, ps), 50),
            "plain_ms": time_ms(
                torch, lambda: vde_plain(dyn, dt, 1, xs, us, ps), 3),
        }
        if len(rows) == 1:
            row["cold_ms"] = graph_ms(lambda: vde(xs, us, ps), cold=True)
        print(f"{key} {name}: max|err| {err:.3e}, kernel {row['ms']:.5f} ms "
              f"by graph replay ({row['events_ms']:.5f} ms by events, back "
              f"to back), "
              f"plain {row['plain_ms']:.3f} ms, launches (comparison "
              f"instance) {vde.launches}")
    dyn, ps = next(iter(cases.values()))
    n_bytes = 4 * (xs.numel() + us.numel() + ps.numel()
                   + B * N * (nx * nx + nx * nu + nx))
    n_flops = B * N * (flops_per_stage or sweep_flops_per_stage(dyn, nx, nu, ps))
    bms, by = bound_ms(n_bytes, n_flops)
    ptxas = _build.ptxas_report("vde")
    res = _build.functor_resources("vde", "vde_kernel", dyn.cuda_functor)
    first = next(iter(rows.values()))
    print(f"{key} bound at B={B}, N={N}: {n_bytes / 1e6:.1f} MB, "
          f"{n_flops / 1e9:.2f} GFLOP -> {bms:.4f} ms ({by}); cold "
          f"{first['cold_ms']:.5f} ms ({100 * bms / first['cold_ms']:.0f}% of the "
          f"bound); vde_kernel<{dyn.cuda_functor}> {res['registers']} "
          f"registers, {res['spill_stores']} B spill stores, "
          f"{res['spill_loads']} B spill loads")
    out[key] = {"cases": rows, "bytes": n_bytes, "flops": n_flops,
                "bound_ms": bms, "bound_by": by, "ptxas": ptxas,
                "functor": dyn.cuda_functor, "resources": res}
    return first | res | {"bound_ms": bms, "bound_by": by, "max_abs_err": max(
        r["max_abs_err"] for r in rows.values())}


def bicycle_cases(torch, B):
    """The c2 bicycle at switch 1 and 0.3."""
    from ad_mpc_tpu_torch import fleet

    return {f"switch={s}": (fleet.dynamic_bicycle,
                            torch.full((B, 1), s, device="cuda"))
            for s in (1.0, 0.3)}


def pacejka_cases(torch, B):
    """c4's Pacejka with p drawn per scenario by ``p_of`` (the fleet's
    draw), and the same draw at the sweep's lowest friction, mu = 0.6."""
    from ad_mpc_tpu_torch.fleet import pacejka_draw

    dyn, ps = pacejka_draw(B)
    ps = torch.as_tensor(ps, device="cuda")
    low = ps.clone()
    low[:, 0] = 0.6
    return {"p_of": (dyn, ps), "mu=0.6": (dyn, low)}


def gp_bicycle_cases(torch, B):
    """c3's GP bicycle at switch 1 with the bench's 32-point ensemble, and
    with the 8-point twin of the same draw."""
    from ad_mpc_tpu_torch import fleet

    ps = torch.ones((B, 1), device="cuda")
    return {f"n={n}": (fleet.make_gp_bicycle(n), ps) for n in (32, 8)}


def c2_traj(torch, np, seed, B=16384, N=30):
    from ad_mpc_tpu_torch.testing import random_traj

    return [torch.as_tensor(a).cuda()
            for a in random_traj(np.random.default_rng(seed), B, N, 7, 2)]


def phase_vde(torch, np, out):
    xs, us = c2_traj(torch, np, 3)
    return vde_case(torch, out, "vde", bicycle_cases(torch, xs.shape[0]), 0.05,
                    xs, us, 2e-5)


def phase_vde_pacejka(torch, np, out):
    xs, us = c2_traj(torch, np, 3)
    return vde_case(torch, out, "vde_pacejka",
                    pacejka_cases(torch, xs.shape[0]), 0.05, xs, us, 2e-5)


def phase_vde_gp_bicycle(torch, np, out):
    from ad_mpc_tpu_torch import fleet

    xs, us = c2_traj(torch, np, 3)
    cases = gp_bicycle_cases(torch, xs.shape[0])
    ps = cases["n=32"][1]
    return vde_case(torch, out, "vde_gp_bicycle", cases, 0.05, xs, us, 2e-5,
                    gp_vde_flops_per_stage(fleet.dynamic_bicycle, ps, GP_POINTS))


def phase_vde_quad(torch, np, out):
    from ad_mpc_tpu_torch.models.quadrotor import QuadDynamics
    from ad_mpc_tpu_torch.testing import quad_traj

    B = 16384
    xs, us = (torch.as_tensor(a).cuda()
              for a in quad_traj(np.random.default_rng(13), B, 10))
    cases = {"p_dim=0": (QuadDynamics(), torch.zeros((B, 0), device="cuda"))}
    return vde_case(torch, out, "vde_quad", cases, 0.1, xs, us, 3e-5)


def rk4_case(torch, out, key, cases, dt, xs, us, atol, flops_per_row=None,
             anchor=()):
    """Both modes of the tangent-free RK4 entry (the KKT defect over every
    stage, and the plant step with u a strided view ``us[:, 0]``) against
    ``integrators.discrete_step`` at ``atol``, for each case of ``cases``
    ({name: (dynamics, ps)}), the cases named in ``anchor`` by
    :func:`anchored` instead; device times warm and, at the first case,
    cold (the bytes of either mode fit the 50 MB L2); registers and
    spills of the first case's functor. The bound counts
    ``flops_per_row``, by default the first case's operations as
    :func:`sweep_flops_per_stage` counts them."""
    from ad_mpc_tpu_torch.experiments import graph_ms
    from ad_mpc_tpu_torch.experiments.opcount import dyn_counts, rk4_flops
    from ad_mpc_tpu_torch.ops import _build
    from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4
    from ad_mpc_tpu_torch.ops.integrators import discrete_step

    B, N, nx = xs.shape[0], xs.shape[1] - 1, xs.shape[2]
    nu = us.shape[-1]
    x, u = xs[:, 0].contiguous(), us[:, 0]  # u strided, as the plant step's
    rows, first = {}, next(iter(cases))
    for name, (dyn, ps) in cases.items():
        rk4 = make_rk4(dyn, dt, nx, nu, ps.shape[-1], device="cuda")
        modes = {
            "defect": (lambda: rk4.defect(xs, us, ps),
                       lambda d, a, b, c: discrete_step(d, dt, 1, a[:, :-1], b,
                                                        c[:, None]) - a[:, 1:],
                       (xs, us, ps)),
            "step": (lambda: rk4(x, u, ps),
                     lambda d, a, b, c: discrete_step(d, dt, 1, a, b, c),
                     (x, u, ps)),
        }
        for mode, (kernel, plain_of, args) in modes.items():
            plain = lambda: plain_of(dyn, *args)
            extra = {}
            if name in anchor:
                err, extra = anchored(f"{key} {mode}", name, (kernel(),),
                                      lambda *a: (plain_of(*a),), dyn, args,
                                      atol, (False,))
            else:
                err, ok = max_err(kernel(), plain(), atol)
                check(ok, f"{key} {mode} disagrees with discrete_step at {name}: "
                      f"max |err| {err:.3e} > {atol}")
            rows[mode, name] = extra | {
                "max_abs_err": err, "ms": graph_ms(kernel),
                "plain_ms": time_ms(torch, plain, 5)}
            if name == first:
                rows[mode, name]["cold_ms"] = graph_ms(kernel, cold=True)
    dyn, ps = cases[first]
    pd = ps.shape[-1]
    res = _build.functor_resources("vde", "rk4_kernel", dyn.cuda_functor)
    bounds = {}
    for mode, n_rows, n_in in (("defect", B * N, xs.numel() + us.numel()),
                               ("step", B, B * (nx + nu))):
        n_bytes = 4 * (n_in + B * pd + n_rows * nx)
        n_flops = n_rows * (flops_per_row or rk4_flops(
            dyn_counts(dyn, nx, nu, ps[0].cpu()), nx))
        bms, by = bound_ms(n_bytes, n_flops)
        bounds[mode] = {"bytes": n_bytes, "flops": n_flops, "bound_ms": bms,
                        "bound_by": by}
        r = rows[mode, first]
        err = max(rows[mode, n]["max_abs_err"] for n in cases)
        print(f"{key} {mode}: max|err| {err:.3e}, kernel {r['ms']:.5f} ms "
              f"warm by graph replay, {r['cold_ms']:.5f} ms cold ({100 * bms / r['cold_ms']:.0f}% "
              f"of the bound), plain {r['plain_ms']:.3f} ms, bound {bms:.5f} ms "
              f"({by}: {n_bytes / 1e6:.1f} MB, {n_flops / 1e9:.3f} GFLOP)")
    print(f"{key}: rk4_kernel<{dyn.cuda_functor}> {res['registers']} registers, "
          f"{res['spill_stores']} B spill stores, {res['spill_loads']} B spill loads")
    out[key] = {"cases": {f"{m}_{n}": r for (m, n), r in rows.items()},
                "bounds": bounds, "functor": dyn.cuda_functor, "resources": res}
    return rows["defect", first] | bounds["defect"] | res | {"max_abs_err": max(
        r["max_abs_err"] for r in rows.values())}


def phase_rk4(torch, np, out):
    xs, us = c2_traj(torch, np, 4)
    return rk4_case(torch, out, "rk4", bicycle_cases(torch, xs.shape[0]), 0.05,
                    xs, us, 2e-5)


def phase_rk4_pacejka(torch, np, out):
    xs, us = c2_traj(torch, np, 4)
    return rk4_case(torch, out, "rk4_pacejka",
                    pacejka_cases(torch, xs.shape[0]), 0.05, xs, us, 2e-5)


def phase_rk4_gp_bicycle(torch, np, out):
    from ad_mpc_tpu_torch import fleet

    xs, us = c2_traj(torch, np, 4)
    cases = gp_bicycle_cases(torch, xs.shape[0])
    ps = cases["n=32"][1]
    return rk4_case(torch, out, "rk4_gp_bicycle", cases, 0.05, xs, us, 2e-5,
                    gp_rk4_flops_per_row(fleet.dynamic_bicycle, ps, GP_POINTS))


def phase_rk4_quad(torch, np, out):
    from ad_mpc_tpu_torch.models.quadrotor import QuadDynamics
    from ad_mpc_tpu_torch.testing import quad_traj

    B = 16384
    xs, us = (torch.as_tensor(a).cuda()
              for a in quad_traj(np.random.default_rng(14), B, 10))
    cases = {"p_dim=0": (QuadDynamics(), torch.zeros((B, 0), device="cuda"))}
    return rk4_case(torch, out, "rk4_quad", cases, 0.1, xs, us, 3e-5)


def gp_quad_cases(torch, B):
    """c6's GP-quad with the bench's synthetic 32-point ensemble and with
    the fitted 60-point ``gp_flagship_c1`` model."""
    from ad_mpc_tpu_torch.experiments import quad_fleet
    from ad_mpc_tpu_torch.models.gp_quad import GPQuadDynamics

    ps = torch.zeros((B, 0), device="cuda")
    return {"n=32": (GPQuadDynamics(quad_fleet.make_quad_gp_ensemble()), ps),
            "fitted n=60": (GPQuadDynamics(quad_fleet.fitted_ensemble()), ps)}


def phase_vde_gp_quad(torch, np, out):
    from ad_mpc_tpu_torch.testing import quad_traj

    B = 16384
    xs, us = (torch.as_tensor(a).cuda()
              for a in quad_traj(np.random.default_rng(13), B, 10))
    cases = gp_quad_cases(torch, B)
    row = vde_case(torch, out, "vde_gp_quad", cases, 0.1, xs, us, 3e-5,
                   gp_quad_vde_flops_per_stage(GP_QUAD_POINTS),
                   anchor=("fitted n=60",))
    # The fitted model's own bound (60 points), against its warm time.
    fit = out["vde_gp_quad"]["cases"]["fitted n=60"]
    bms, by = bound_ms(out["vde_gp_quad"]["bytes"],
                       B * 10 * gp_quad_vde_flops_per_stage(60))
    check(bms <= fit["ms"], f"vde_gp_quad fitted: {fit['ms']:.5f} ms is under "
          f"its bound {bms:.5f} ms: the count is wrong")
    fit |= {"bound_ms": bms, "bound_by": by}
    print(f"vde_gp_quad fitted n=60 bound {bms:.4f} ms ({by}), "
          f"{100 * bms / fit['ms']:.0f}% of it warm")
    return row


def phase_rk4_gp_quad(torch, np, out):
    from ad_mpc_tpu_torch.testing import quad_traj

    B = 16384
    xs, us = (torch.as_tensor(a).cuda()
              for a in quad_traj(np.random.default_rng(14), B, 10))
    return rk4_case(torch, out, "rk4_gp_quad", gp_quad_cases(torch, B), 0.1,
                    xs, us, 3e-5, gp_quad_rk4_flops_per_row(GP_QUAD_POINTS),
                    anchor=("fitted n=60",))


def tick_qps(fleet, batch, n_nodes):
    """The c2 solver's QP module and the inputs of its QP at the third tick
    of a fleet of ``batch`` vehicles."""
    from ad_mpc_tpu_torch.experiments import tick_qp_inputs

    tick, init, solver, spec = fleet.build_fleet(
        fleet.dynamic_bicycle, fleet.switch_on, n_nodes=n_nodes, device="cuda")
    return solver.qp, tick_qp_inputs(tick, init, solver, batch), spec


def quad_tick_qps(batch):
    """The c5 solver's QP module and the inputs of the last QP of its third
    tick (the second Gauss-Newton iteration) at ``batch`` vehicles."""
    from ad_mpc_tpu_torch.experiments import quad_fleet, tick_qp_inputs

    tick, init, solver, _ = quad_fleet.build_quad_fleet(device="cuda")
    return solver.qp, tick_qp_inputs(tick, init, solver, batch)


def lq_resources(nx):
    """Registers and spills of the LQ kernel of shape nx (7x2 or 13x4) from
    the ``-Xptxas -v`` report of ``csrc/lq_ipm.cu``."""
    from ad_mpc_tpu_torch.ops import _build

    tag = "lq_ipm_kernelILi7ELi2E" if nx == 7 else "lq_wide18lq_ipm_wide_kernel"
    found = [r for e, r in _build.ptxas_resources("lq_ipm").items() if tag in e]
    check(len(found) == 1, f"{len(found)} ptxas entries of the {nx}-state LQ kernel")
    return found[0]


def lq_cases(torch, out, key, cases, cold=()):
    """``lq_case`` on each of ``cases`` ({name: (solver, inputs, strict)}),
    with its launch geometry, its time against its bound by CUDA-graph
    replay and, for the names in ``cold``, its time with the inputs out of
    L2; the kernel's registers and spills. Returns the rows."""
    from ad_mpc_tpu_torch.experiments import graph_ms
    from ad_mpc_tpu_torch.ops.cuda_lq import team_lanes
    from ad_mpc_tpu_torch.testing import SPREAD_FACTOR, lq_case

    rows = {}
    for name, (qp, args, strict) in cases.items():
        row, ok, plain = lq_case(qp, args, strict)
        check(ok, f"LQ kernel disagrees with its plain version ({name}): {row}")
        B, N, nx = args[0].shape[:3]
        nu = args[1].shape[-1]
        n_bytes = 4 * (sum(a.numel() for a in args)
                       + B * ((N + 1) * nx + N * nu + 1))
        n_flops = B * N * qp.iters * lq_flops_per_stage_iter(nx, nu)
        bms, by = bound_ms(n_bytes, n_flops)
        geo = qp.geometry_for(B)
        per_sm = qp.occupancy(B)
        row |= {"N": N, "nx": nx, "nu": nu,
                "ms": graph_ms(lambda: qp(*args), inner=5),
                "events_ms": time_ms(torch, lambda: qp(*args), 10),
                "plain_ms": time_ms(torch, plain, 2), "bytes": n_bytes,
                "flops": n_flops, "bound_ms": bms, "bound_by": by,
                "geometry": geo._asdict() | {"blocks": geo.blocks(B)},
                "threads_per_scenario": team_lanes(nx),
                "shared_bytes_per_scenario": 4 * geo.pitch,
                "blocks_per_sm": per_sm, "scenarios_per_sm": per_sm * geo.teams,
                } | lq_resources(nx)
        if name in cold:
            row["cold_ms"] = graph_ms(lambda: qp(*args), inner=5, cold=True)
        rows[name] = row
        print(f"LQ {name} geometry: {geo.teams} scenarios and {geo.threads} "
              f"threads per block ({team_lanes(nx)} per scenario), "
              f"{geo.block_bytes} shared bytes per block ({4 * geo.pitch} per "
              f"scenario), {geo.blocks(B)} blocks, {per_sm} resident per SM "
              f"({row['scenarios_per_sm']} scenarios; "
              f"cudaOccupancyMaxActiveBlocksPerMultiprocessor); "
              f"{row['registers']} registers, {row['spill_stores']} B spill "
              f"stores, {row['spill_loads']} B spill loads")
        cold_txt = (f", {row['cold_ms']:.4f} ms cold" if "cold_ms" in row else "")
        print(f"LQ {name} B={B} N={N} {nx}x{nu}: {row['agree']}/{B} scenarios "
              f"agree (max|err| {row['max_abs_err']:.3e}); outside tolerance of the "
              f"float64 solution: kernel {row['kernel_misses_f64']}, plain "
              f"{row['plain_misses_f64']}; spread factor {row['factor']:.3f} (limit "
              f"{SPREAD_FACTOR}; plain on the CPU {row['control_factor']:.3f}); "
              f"fixed-tolerance misses {row['fixed_tol_misses']} (plain on the "
              f"CPU {row['control_fixed_tol_misses']}); "
              f"deterministic {row['deterministic']}; kernel {row['ms']:.4f} ms "
              f"warm by graph replay{cold_txt} ({row['events_ms']:.4f} ms by "
              f"events, back to back; {100 * bms / row.get('cold_ms', row['ms']):.1f}%"
              f" of the bound), plain {row['plain_ms']:.3f} ms, bound {bms:.4f} ms "
              f"({by}: {n_bytes / 1e6:.1f} MB, {n_flops / 1e9:.2f} GFLOP)")
    out[key] = rows
    return rows


def phase_lq(torch, np, out):
    from ad_mpc_tpu_torch import fleet
    from ad_mpc_tpu_torch.ops.cuda_lq import make_lq_solver
    from ad_mpc_tpu_torch.testing import BOUNDS, LQ_WEIGHTS, random_lq

    # The QPs of the main path: the inputs of the third c2 tick.
    qp_c2, args_c2, spec = tick_qps(fleet, 16384, 30)
    qp_1024, args_1024, _ = tick_qps(fleet, 1024, 30)
    qp_n40, args_n40, _ = tick_qps(fleet, 16384, 40)
    Q, R = LQ_WEIGHTS
    rand = lambda B, N: [torch.as_tensor(a).cuda()
                         for a in random_lq(np.random.default_rng(5), B, N, 7, 2)]
    cases = {
        # name: (solver, inputs, strict)
        "c2_tick": (qp_c2, args_c2, True),
        "c2_tick_B1024": (qp_1024, args_1024, True),
        "c2_n40_tick": (qp_n40, args_n40, False),
        "random_N30": (make_lq_solver(30, 7, 2, Q, R, 1e-3 * Q,
                                      *spec.bound_dicts(), iters=12),
                       rand(16384, 30), False),
        "random_N10_unit": (make_lq_solver(10, 7, 2, Q, R, 1e-3 * Q,
                                           *BOUNDS["unit"](7, 2), iters=12),
                            rand(1000, 10), False),
    }
    # The main path's case and row 3's 7x2 case (the stage-unrolled twin's
    # N=10), which fits L2, are timed cold too.
    return lq_cases(torch, out, "lq", cases,
                    cold=("c2_tick", "random_N10_unit"))["c2_tick"]


def phase_lq_quad(torch, np, out):
    from ad_mpc_tpu_torch.ops.cuda_lq import make_lq_solver
    from ad_mpc_tpu_torch.testing import BOUNDS, QUAD_LQ_WEIGHTS, random_lq

    qp_c5, args_c5 = quad_tick_qps(16384)
    qp_1024, args_1024 = quad_tick_qps(1024)
    Q, R = QUAD_LQ_WEIGHTS
    rand = [torch.as_tensor(a).cuda()
            for a in random_lq(np.random.default_rng(6), 16384, 10, 13, 4)]
    cases = {
        "c5_tick": (qp_c5, args_c5, True),
        "c5_tick_B1024": (qp_1024, args_1024, True),
        "random_N10_unit_13x4": (make_lq_solver(10, 13, 4, Q, R, 10 * Q,
                                                *BOUNDS["unit"](13, 4), iters=18),
                                 rand, False),
    }
    return lq_cases(torch, out, "lq_13x4", cases,
                    cold=("c5_tick", "c5_tick_B1024"))["c5_tick"]


def fleet_ladder(config, build, batches, warmup, ticks, gates, per_tick, card):
    """One fleet row per batch size: a fresh fleet from ``build()``, its
    kernels' launch counts set to 0, ``warmup`` + ``ticks`` ticks
    (``fleet.run_config``), then each kernel's launches against
    ``per_tick`` and the row against ``gates``. Returns {B: (row, carry)}."""
    from ad_mpc_tpu_torch import fleet

    rows = {}
    for B in batches:
        tick, init, solver, _ = build()
        zero_launches(solver)
        row, carry = fleet.run_config(tick, init, B, ticks=ticks, warmup=warmup)
        launches = row["launches"] = fleet.launches(solver)
        check_launches(per_tick, launches, warmup + ticks,
                       f"({config}) at B={B}")
        bad = [k for k, lim in gates.items() if not row[k] <= lim]
        check(not bad, f"{config} gates failed at B={B}: "
              + ", ".join(f"{k}={row[k]:.3e}" for k in bad))
        rows[B] = row, carry
        print(f"{config} B={B}: {row['solves_per_s']:.1f} solves/s "
              f"({row['tick_ms']:.3f} ms/tick) on {card}; kkt mean "
              f"{row['kkt_mean']:.3e} max {row['kkt_max']:.3e}, lat_err "
              f"{row['lat_err_mean_m']:.4f} m, launches {launches}")
    return rows


def rti_check(config, d_u0, lim):
    check(d_u0 <= lim, f"{config} RTI-vs-converged u0 {d_u0:.3e} > {lim}")
    print(f"{config} RTI vs converged: max|du0| {d_u0:.3e} (gate {lim})")
    return d_u0


def phase_slice(torch, out, card):
    from ad_mpc_tpu_torch import fleet

    rows = fleet_ladder(
        "c2", lambda: fleet.build_fleet(fleet.dynamic_bicycle, fleet.switch_on,
                                        device="cuda"),
        (1024, 16384), WARMUP, TICKS, fleet.CONFIG_GATES["c2"],
        fleet.LAUNCHES_PER_TICK, card)
    out["rti_vs_converged_u0"] = rti_check("c2", fleet.rti_vs_converged(
        fleet.dynamic_bicycle, fleet.switch_on, rows[1024][1]),
        fleet.RTI_GATES["c2"])
    out["slice"] = {str(B): r for B, (r, _) in rows.items()}
    return rows[16384][0]["launches"]


def phase_c3(torch, out, card):
    """c3: the GP bicycle fleet at B=256/4096/16384 (bench.py:719-734)."""
    from ad_mpc_tpu_torch import fleet

    dyn = fleet.make_gp_bicycle()
    rows = fleet_ladder(
        "c3", lambda: fleet.build_fleet(dyn, fleet.switch_on, device="cuda"),
        (256, 4096, 16384), WARMUP, TICKS, fleet.CONFIG_GATES["c3"],
        fleet.LAUNCHES_PER_TICK, card)
    out["c3"] = {str(B): r for B, (r, _) in rows.items()}
    return rows[16384][0]["launches"]


def phase_c4(torch, out, card):
    """c4: the Pacejka sweep at B=4096, 45 warm-up and 10 timed ticks
    (bench.py:737-758), then RTI against a converged solve."""
    from ad_mpc_tpu_torch import fleet

    dyn, p_of, v_cap = fleet.make_pacejka()
    rows = fleet_ladder(
        "c4", lambda: fleet.build_fleet(dyn, p_of, v_cap=v_cap, device="cuda"),
        (4096,), fleet.C4_WARMUP, fleet.C4_TICKS, fleet.CONFIG_GATES["c4"],
        fleet.LAUNCHES_PER_TICK, card)
    row, carry = rows[4096]
    out["c4"] = {"4096": row}
    out["c4_rti_vs_converged_u0"] = rti_check(
        "c4", fleet.rti_vs_converged(dyn, p_of, carry), fleet.RTI_GATES["c4"])
    return row["launches"]


def phase_c5(torch, out, card):
    from ad_mpc_tpu_torch.experiments import quad_fleet

    rows = fleet_ladder(
        "c5", lambda: quad_fleet.build_quad_fleet(device="cuda"),
        (256, 1024, 4096, 16384), C5_WARMUP, TICKS, quad_fleet.GATES,
        quad_fleet.LAUNCHES_PER_TICK, card)
    out["c5_rti_vs_converged_u0"] = rti_check(
        f"c5 ({quad_fleet.QUAD_SQP_ITERS} Gauss-Newton iterations)",
        quad_fleet.rti_vs_converged_quad(rows[256][1]), quad_fleet.RTI_GATE)
    out["c5"] = {str(B): r for B, (r, _) in rows.items()}
    return rows[16384][0]["launches"]


def phase_c6(torch, out, card):
    """c6: the GP-quad fleet with the bench's synthetic ensemble at
    B=256/1024/4096/16384, RTI on the B=256 fleet, then the c6-fitted fleet
    at B=4096/16384 (bench.py:798-856)."""
    from ad_mpc_tpu_torch.experiments import quad_fleet

    ens = quad_fleet.make_quad_gp_ensemble()
    rows = fleet_ladder(
        "c6", lambda: quad_fleet.build_quad_fleet(device="cuda", ensemble=ens),
        (256, 1024, 4096, 16384), C5_WARMUP, TICKS, quad_fleet.GATES,
        quad_fleet.LAUNCHES_PER_TICK, card)
    out["c6_rti_vs_converged_u0"] = rti_check(
        "c6", quad_fleet.rti_vs_converged_quad(rows[256][1], ensemble=ens),
        quad_fleet.RTI_GATE)
    out["c6"] = {str(B): r for B, (r, _) in rows.items()}
    fitted = quad_fleet.fitted_ensemble()
    rows_f = fleet_ladder(
        "c6-fitted", lambda: quad_fleet.build_quad_fleet(device="cuda",
                                                         ensemble=fitted),
        (4096, 16384), C5_WARMUP, TICKS, quad_fleet.FITTED_GATES,
        quad_fleet.LAUNCHES_PER_TICK, card)
    out["c6_fitted"] = {str(B): r for B, (r, _) in rows_f.items()}
    return rows[16384][0]["launches"]


def phase_lane_chain(torch, out):
    from ad_mpc_tpu_torch.experiments import graph_ms
    from ad_mpc_tpu_torch.experiments.mxu_riccati import bmm_chain, inputs
    from ad_mpc_tpu_torch.ops import _build
    from ad_mpc_tpu_torch.ops.cuda_chain import (
        chain_geometry, from_lanes, lane_chain_plain, make_lane_chain, to_lanes)

    B, nx, chain = 16384, 7, 12
    lane = make_lane_chain(nx, chain, device="cuda")  # comparison instance
    A, X = inputs(B, nx, 0, "cuda")
    a, x = to_lanes(A), to_lanes(X)
    got, again = lane(a, x), lane(a, x)
    want = lane_chain_plain(a, x, chain)
    lib = bmm_chain(A, X, chain)  # TF32 is off
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    err_lib = float((from_lanes(got, nx) - lib).abs().max())
    check(bool(got.isfinite().all()) and err <= 1e-5 * scale,
          f"lane_chain disagrees with its plain version: max |err| {err:.3e} "
          f"> 1e-5 x {scale:.3e}")
    check(err_lib <= 1e-5 * scale,
          f"lane_chain disagrees with the fp32 bmm chain: {err_lib:.3e}")
    check(torch.equal(got, again), "lane_chain: a relaunch changed its bits")
    geo = chain_geometry(B, nx)
    per_sm = lane.occupancy()
    print(f"lane_chain geometry: {geo.blocks} blocks of {geo.threads} threads "
          f"({geo.scenarios} scenarios, a warp per column), {geo.block_bytes} "
          f"shared bytes per block, {per_sm} resident per SM "
          f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    n_bytes = 3 * B * nx * nx * 4
    n_flops = 2 * B * nx**3 * chain
    bms, by = bound_ms(n_bytes, n_flops)
    with_tf32 = lambda: bmm_chain(A, X, chain)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_ms = graph_ms(with_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    row = {
        "max_abs_err": err, "max_rel_err": err / scale,
        "max_rel_err_vs_bmm_f32": err_lib / scale,
        "ms": graph_ms(lambda: lane(a, x)),
        "cold_ms": graph_ms(lambda: lane(a, x), cold=True),
        "events_ms": time_ms(torch, lambda: lane(a, x), 200),
        "plain_ms": time_ms(torch, lambda: lane_chain_plain(a, x, chain), 3),
        "library_ms": graph_ms(lambda: bmm_chain(A, X, chain)),
        "library_tf32_ms": tf32_ms,
        "bytes": n_bytes, "flops": n_flops, "bound_ms": bms, "bound_by": by,
        "geometry": geo._asdict(), "blocks_per_sm": per_sm,
        "ptxas": _build.ptxas_report("lane_chain"),
    }
    print(f"ptxas lane_chain:\n{row['ptxas']}")
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", row["ptxas"])
    check(all(n == "0" for n in spills), "lane_chain spills registers")
    print(f"lane_chain B={B} chain={chain}: max|err| {err:.3e} ({err / scale:.2e}"
          f" of max|out|; vs fp32 bmm {err_lib / scale:.2e}); kernel "
          f"{row['ms']:.5f} ms by graph replay ({row['events_ms']:.5f} ms by events, "
          f"back to back; cold {row['cold_ms']:.5f} ms, "
          f"{100 * bms / row['cold_ms']:.0f}% of the bound), plain "
          f"{row['plain_ms']:.3f} ms, 12 x torch.bmm fp32 "
          f"{row['library_ms']:.5f} ms (TF32 {tf32_ms:.5f} ms), bound "
          f"{bms:.5f} ms ({by}: {n_bytes / 1e6:.2f} MB, {n_flops / 1e6:.1f} MFLOP)")
    out["lane_chain"] = row
    return row


def phase_mxu(torch, out):
    from ad_mpc_tpu_torch import fleet
    from ad_mpc_tpu_torch.experiments import mxu_riccati
    from ad_mpc_tpu_torch.ops.cuda_chain import make_lane_chain
    from ad_mpc_tpu_torch.testing import SPREAD_FACTOR

    lane = make_lane_chain(device="cuda")
    lane.launches = 0
    micro = mxu_riccati.micro(lane=lane)
    launches = lane.launches
    check(not torch.backends.cuda.matmul.allow_tf32,
          "the micro left TF32 switched on")
    numbers = [v for k, v in micro.items() if isinstance(v, float)]
    check(all(v == v and abs(v) != float("inf") for v in numbers),
          f"non-finite output of the MXU micro: {micro}")
    lane64, bmm64 = micro["cuda_lane_rel_err_vs_f64"], micro["bmm_f32_rel_err_vs_f64"]
    check(lane64 <= SPREAD_FACTOR * bmm64,
          f"lane arm {lane64:.3e} from float64 > {SPREAD_FACTOR} x the fp32 "
          f"bmm arm's {bmm64:.3e}")
    captured, replays = micro["cuda_lane_captured_launches"], micro["cuda_lane_replays"]
    check(captured == mxu_riccati.INNER
          and captured * replays == micro["cuda_lane_applications"],
          f"lane_chain: {captured} launches captured for a block of "
          f"{mxu_riccati.INNER} applications, x {replays} replays, for "
          f"{micro['cuda_lane_applications']} applications")
    check(launches == mxu_riccati.INNER + captured,
          f"lane_chain launched {launches} times through the wrapper, "
          f"expected the warm-up block and the capture ({2 * mxu_riccati.INNER})")
    print(f"MXU micro: per application bmm TF32 {micro['bmm_tf32_ms']:.5f} ms, "
          f"bmm fp32 {micro['bmm_f32_ms']:.5f} ms, cuda_lane "
          f"{micro['cuda_lane_ms']:.5f} ms ({micro['cuda_lane_gflops']:.1f} "
          f"GFLOP/s, {micro['cuda_lane_pct_fp32_peak']:.2f}% of FP32 peak); "
          f"lane vs fp32 {micro['max_rel_diff_vs_f32']:.2e}, TF32 vs fp32 "
          f"{micro['tf32_max_rel_diff_vs_f32']:.2e}; from float64: lane "
          f"{lane64:.2e}, bmm fp32 {bmm64:.2e}, bmm TF32 "
          f"{micro['bmm_tf32_rel_err_vs_f64']:.2e}; spread "
          f"{micro['spread_max_over_min']}; lane_chain launches {launches} "
          f"({captured} captured, replayed {replays} times: "
          f"{micro['cuda_lane_applications']} applications)")
    macro = mxu_riccati.macro()
    cuda_arm = macro["cuda"]
    check(cuda_arm["kkt_max"] <= fleet.CONFIG_GATES["c2"]["kkt_max"],
          f"macro cuda arm kkt_max {cuda_arm['kkt_max']:.3e}")
    check(cuda_arm["launches"] == {"vde": 15, "lq_ipm": 15, "rk4": 30}
          and macro["plain"]["launches"] == {"vde": 0, "lq_ipm": 0, "rk4": 0},
          f"macro launches {macro}")
    print(f"MXU macro c2 B=4096: cuda {cuda_arm['solves_per_s']:.1f} solves/s "
          f"(kkt_max {cuda_arm['kkt_max']:.3e}), plain "
          f"{macro['plain']['solves_per_s']:.1f} solves/s (kkt_max "
          f"{macro['plain']['kkt_max']:.3e}); launches {cuda_arm['launches']}")
    out["mxu_micro"], out["mxu_macro"] = micro, macro
    return launches


def phase_long_horizon(out):
    from ad_mpc_tpu_torch.experiments import long_horizon

    res = long_horizon.micro()
    for name, row in res["rows"].items():
        print(f"long horizon {name}: seq {row['seq_ms']:.4f} ms, assoc "
              f"{row['assoc_ms']:.4f} ms (assoc/seq {row['assoc_over_seq']:.3f}),"
              f" rel diff {row['max_rel_diff']:.2e}, spread {row['spread']}")
        check(all(v == v for v in (row["seq_ms"], row["assoc_ms"],
                                   row["max_rel_diff"])),
              f"non-finite long-horizon row {name}")
    for name in ("N30", "N128"):
        d = res["rows"][name]["max_rel_diff"]
        check(d < 2e-3, f"assoc vs sequential at {name}: {d:.3e} >= 2e-3")
    print(f"long horizon crossover_n: {res['crossover_n']}")
    out["long_horizon"] = res


def phase_c2_n40(torch, out, card):
    from ad_mpc_tpu_torch import fleet

    rows = fleet_ladder(
        "c2-N40", lambda: fleet.build_fleet(fleet.dynamic_bicycle,
                                            fleet.switch_on, n_nodes=40,
                                            device="cuda"),
        (16384,), WARMUP, TICKS, fleet.CONFIG_GATES["c2"],
        fleet.LAUNCHES_PER_TICK, card)
    out["c2_n40"] = rows[16384][0]


def phase_latency(out):
    from ad_mpc_tpu_torch import fleet

    lat = fleet.bench_latency(fleet.dynamic_bicycle, fleet.switch_on)
    check_launches(fleet.LAUNCHES_PER_TICK, lat["launches"], lat["ticks"],
                   "(latency)")
    check(all(lat[k] == lat[k] and lat[k] > 0 for k in (
        "p50_compute", "p99_compute", "p50_blocking", "p99_blocking",
        "host_link_floor_p50")), f"latency row {lat}")
    print(f"latency B=1: compute p50 {lat['p50_compute']:.3f} ms p99 "
          f"{lat['p99_compute']:.3f} ms ({lat['compute_method']}); blocking "
          f"p50 {lat['p50_blocking']:.3f} ms p99 {lat['p99_blocking']:.3f} ms; "
          f"floor p50 {lat['host_link_floor_p50']:.3f} ms; budget "
          f"{lat['budget']} ms; launches {lat['launches']}")
    if lat["p99_compute"] > lat["budget"]:
        print(f"WARNING: latency compute p99 {lat['p99_compute']:.2f} ms is "
              f"over the {lat['budget']} ms budget")
    out["latency"] = lat


# Phase 11, the single-vehicle AD path: the deployment rows and RMSE gates
# are the port's bench's (``bench.DEPLOY_ROWS``, ``bench.AD_GATES``); the
# JAX package's RMSEs (``BENCH_r05.json``) are printed beside, not gated.
JAX_DEPLOY_RMSE = {"deployment_loop_50hz": 0.115,
                   "deployment_loop_50hz_pipelined": 0.116,
                   "deployment_aggr_nolagcomp": 2.780,
                   "deployment_aggr_lagcomp": 0.160}
AD_SOLVES = ((40, 18), (20, 10))  # (N, qp_iters): closed loop, deployment node


def ad_solvers(torch, N, qp_iters, **spec_kw):
    """SQPSolver on the card through the kernels and through their plain
    versions, at horizon N (dt = 0.05 s)."""
    import dataclasses

    from ad_mpc_tpu_torch import fleet
    from ad_mpc_tpu_torch.control.mpc import bicycle_spec
    from ad_mpc_tpu_torch.ocp.solver import SQPSolver

    spec = dataclasses.replace(
        bicycle_spec(t_horizon=0.05 * N, n_nodes=N, qp_iters=qp_iters), **spec_kw)
    return [SQPSolver(spec, fleet.dynamic_bicycle, p_dim=1, device="cuda",
                      backend=b) for b in ("cuda", "plain")]


def ad_solve_case(torch, np, out, N, qp_iters):
    """One vehicle at horizon N: an RTI solve through the kernels against
    the plain solver on the card (u0 within 1e-3), its launches (one of
    each kernel), per-stage p by the one-stage route giving the broadcast
    launch's bits, point-reference mode (10 Gauss-Newton iterations, 6
    line-search candidates; u0 within 1e-3, launches), and each solve's
    device time by graph replay. Returns the kernel inputs of the RTI
    solve: (vde (xs, us, ps), qp inputs, qp module)."""
    from ad_mpc_tpu_torch import fleet
    from ad_mpc_tpu_torch.experiments import graph_ms
    from ad_mpc_tpu_torch.testing import bike_instance

    kern, plain = ad_solvers(torch, N, qp_iters)
    x0, yref, yu, p = (torch.as_tensor(a, dtype=torch.float32, device="cuda")
                       for a in bike_instance(np.random.default_rng(21), N, 0.05))
    st = plain.init_state(x0)
    seen = {}
    hooks = [m.register_forward_pre_hook(lambda mod, a, k=k: seen.setdefault(k, a))
             for k, m in (("vde", kern.vde), ("qp", kern.qp))]
    try:
        zero_launches(kern)
        got = kern.solve(x0, yref, yu, p, st)
        rti_launches = fleet.launches(kern)
    finally:
        for h in hooks:
            h.remove()
    want = plain.solve(x0, yref, yu, p, st)
    check(rti_launches == {"vde": 1, "lq_ipm": 1, "rk4": 1},
          f"AD N={N}: launches per RTI solve {rti_launches}")
    check(fleet.launches(plain) == {"vde": 0, "lq_ipm": 0, "rk4": 0},
          f"AD N={N}: the plain solver launched a kernel")
    du0 = float((got.us[0] - want.us[0]).abs().max())
    check(du0 < 1e-3 and bool(got.us.isfinite().all()),
          f"AD N={N}: RTI u0 kernels vs plain {du0:.3e} >= 1e-3")
    rows = kern.solve(x0, yref, yu, p.expand(N, 1).contiguous(), st)
    same = all(torch.equal(a, b) for a, b in ((got.us, rows.us), (got.xs, rows.xs)))
    check(same, f"AD N={N}: per-stage p (one-stage route) changed the bits")

    kern_pr, plain_pr = ad_solvers(torch, N, qp_iters, sqp_iters=10, ls_steps=6)
    zero_launches(kern_pr)
    got_pr = kern_pr.solve(x0, yref, yu, p, st)
    pr_launches = fleet.launches(kern_pr)
    want_pr = plain_pr.solve(x0, yref, yu, p, st)
    check(pr_launches == {"vde": 10, "lq_ipm": 10, "rk4": 10 * N + 1},
          f"AD N={N}: launches per point-reference solve {pr_launches}")
    du0_pr = float((got_pr.us[0] - want_pr.us[0]).abs().max())
    check(du0_pr < 1e-3, f"AD N={N}: point-reference u0 {du0_pr:.3e} >= 1e-3")

    solve = lambda s: (lambda: s.solve(x0, yref, yu, p, st))
    row = {"u0_err_rti": du0, "u0_err_point_reference": du0_pr,
           "launches_rti": rti_launches, "launches_point_reference": pr_launches,
           "rti_graph_ms": graph_ms(solve(kern), inner=5),
           "rti_events_ms": time_ms(torch, solve(kern), 20),
           "point_reference_graph_ms": graph_ms(solve(kern_pr), inner=1),
           "point_reference_events_ms": time_ms(torch, solve(kern_pr), 5),
           "rti_plain_ms": time_ms(torch, solve(plain), 3)}
    tic = time.perf_counter()
    for _ in range(20):
        kern.solve(x0, yref, yu, p, st)
        torch.cuda.synchronize()
    row["rti_blocking_ms"] = 1e3 * (time.perf_counter() - tic) / 20
    print(f"AD N={N} qp_iters={qp_iters} B=1: RTI u0 kernels vs plain "
          f"{du0:.3e}, point reference {du0_pr:.3e}; per-stage p route gives "
          f"the broadcast bits; launches per RTI solve {rti_launches}, per "
          f"point-reference solve {pr_launches}; RTI solve "
          f"{row['rti_graph_ms']:.4f} ms by graph replay, "
          f"{row['rti_events_ms']:.4f} ms eager back to back, "
          f"{row['rti_blocking_ms']:.4f} ms blocking (host clock), plain "
          f"{row['rti_plain_ms']:.2f} ms; point reference "
          f"{row['point_reference_graph_ms']:.3f} ms by graph replay, "
          f"{row['point_reference_events_ms']:.3f} ms eager")
    out.setdefault("ad_solve", {})[f"N{N}"] = row
    return seen["vde"], seen["qp"], kern.qp


def phase_ad_kernels(torch, np, out):
    """The three kernels at the shapes the single-vehicle path gives them
    (B=1; N=40 with 18 IPM iterations, N=20 with 10): each held to its
    plain version on the inputs of an RTI solve, timed warm and cold by
    graph replay. Returns {N: (vde row, rk4 row, lq row)}."""
    from ad_mpc_tpu_torch import fleet

    rows = {}
    for N, iters in AD_SOLVES:
        (xs, us, ps), qp_args, qp = ad_solve_case(torch, np, out, N, iters)
        cases = {"switch=0": (fleet.dynamic_bicycle, ps)}
        vde = vde_case(torch, out, f"vde_ad_n{N}", cases, 0.05, xs, us, 2e-5)
        rk4 = rk4_case(torch, out, f"rk4_ad_n{N}", cases, 0.05, xs, us, 2e-5)
        name = f"ad_n{N}"
        lq = lq_cases(torch, out, f"lq_ad_n{N}", {name: (qp, qp_args, True)},
                      cold=(name,))[name]
        rows[N] = (vde, rk4, lq)
    return rows


def windowing_ms(torch, np, dtype, reps=200):
    """Host time per tick of the enveloped reference window (41 points)
    on a 200-point stretch of the oval, on the CPU in ``dtype``."""
    from ad_mpc_tpu_torch.control.reference import PathReference
    from ad_mpc_tpu_torch.experiments.ad_closed_loop import oval_track

    tx, ty, tpsi = oval_track()
    ref = PathReference(traj_horizon=41, traj_dt=0.05, dtype=dtype)
    idx = np.arange(200)
    ref.set_traj(tx[idx], ty[idx], tpsi[idx], np.full(200, 8.0))
    ref.get_waypoints_enveloped(1.0, 0.2, 0.01, 5.0)
    tic = time.perf_counter()
    for _ in range(reps):
        ref.get_waypoints_enveloped(1.0, 0.2, 0.01, 5.0)
    return 1e3 * (time.perf_counter() - tic) / reps


def phase_ad_path(torch, np, out):
    """6. The single-vehicle AD path: the fused step with host syncs made
    errors, the oracle instance through the kernels, the reference
    window's host time, the 20 s closed loop on the oval (N=40) and the
    deployment rows (N=20, 50 Hz, two nodes over the native bridge).
    Returns the launches of the closed loop and of the deployment rows."""
    from ad_mpc_tpu_torch.bench import AD_GATES, DEPLOY_ROWS
    from ad_mpc_tpu_torch.control.mpc import BicycleMPC, bicycle_spec
    from ad_mpc_tpu_torch.experiments.ad_closed_loop import run_closed_loop
    from ad_mpc_tpu_torch.experiments.deployment_loop import run_deployment_loop
    from ad_mpc_tpu_torch.testing import bike_instance, rti_oracle_distance

    mpc = BicycleMPC(spec=bicycle_spec(), device="cuda")
    x0, yref, _, _ = (torch.as_tensor(a, dtype=torch.float32, device="cuda")
                      for a in bike_instance(np.random.default_rng(22), 40, 0.05))
    step, carry = mpc.make_fused_step(), mpc.fused_init(x0)
    packed = torch.cat([x0[None], yref]).contiguous()
    step(packed, *carry)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            fused_out, *carry = step(packed, *carry)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(fused_out.isfinite().all()), f"fused step output {fused_out}")
    print("AD fused step: 3 steps with every host synchronisation an error")

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                           "fixtures", "oracle_bike_n20.npz")
    d_oracle, _ = rti_oracle_distance(fixture, "cuda", backend="cuda")
    check(d_oracle < 1e-3, f"AD oracle: |u0 - u0_oracle| {d_oracle:.3e} >= 1e-3")
    print(f"AD oracle instance (N=20, 30 RTI re-solves, kernels): |u0 - "
          f"u0_oracle| = {d_oracle:.3e} (gate 1e-3)")

    win = {str(dt).split(".")[-1]: windowing_ms(torch, np, dt)
           for dt in (torch.float64, torch.float32)}
    print(f"AD reference window (H=41, host CPU): {win['float64']:.3f} ms per "
          f"tick in float64, {win['float32']:.3f} ms in float32, of the 20 ms period")

    cl = run_closed_loop(device="cuda")
    ticks = cl.n_steps
    want = {"vde": ticks, "lq_ipm": ticks, "rk4": ticks + 40}
    check(cl.launches == want, f"AD closed loop launches {cl.launches}, "
          f"expected {want}")
    lim = AD_GATES["ad_closed_loop"][1]
    check(cl.rmse_pos < lim, f"AD closed loop RMSE {cl.rmse_pos:.4f} m >= {lim}")
    print(f"AD closed loop (oval, v=8 m/s, N=40, {ticks} ticks): RMSE "
          f"{cl.rmse_pos:.4f} m (gate {lim}), v_mean "
          f"{cl.v_mean:.2f} m/s, solve p50 {cl.p50_opt_ms:.3f} ms p99 "
          f"{cl.p99_opt_ms:.3f} ms mean {cl.mean_opt_ms:.3f} ms (budget 20 ms), "
          f"launches {cl.launches}")
    if cl.p99_opt_ms > 20.0:
        print(f"WARNING: AD closed-loop solve p99 {cl.p99_opt_ms:.2f} ms is over "
              "the 20 ms budget")

    deploy, total = {}, {"vde": 0, "lq_ipm": 0, "rk4": 0}
    for name, kw in DEPLOY_ROWS.items():
        d = run_deployment_loop(device="cuda", **kw)
        n = d["n_solves"]
        want = {"vde": n, "lq_ipm": n, "rk4": n + 20}
        check(d["launches"] == want, f"{name}: launches {d['launches']}, "
              f"expected {want}")
        lim = AD_GATES[name][1]
        check(d["tracking_rmse_m"] < lim, f"{name}: RMSE "
              f"{d['tracking_rmse_m']:.4f} m >= {lim}")
        total = {k: total[k] + v for k, v in d["launches"].items()}
        deploy[name] = d
        print(f"AD {name}: RMSE {d['tracking_rmse_m']:.4f} m (gate {lim}; JAX "
              f"package {JAX_DEPLOY_RMSE[name]}), tick p50 "
              f"{d['tick_p50_ms']:.3f} ms p99 {d['tick_p99_ms']:.3f} ms, missed "
              f"{d['missed_deadlines']}/{d['ticks']}, unsafe ticks "
              f"{d['n_unsafe_ticks']}, solves {n}, host-link floor "
              f"{d['host_link_floor_p50_ms']:.4f} ms, scheduler "
              f"{d['scheduler_jitter']}, launches {d['launches']}")
    # The JAX package's A/B (2.780 against 0.160 m) ran behind a link of
    # 24-27 ms, over a period: its uncompensated row published commands two
    # or more ticks old and braked on 210 unsafe ticks. Here a result is
    # back within its tick (the age printed), so the comparison is shown,
    # not gated; every row is held to the RMSE gate above.
    lag, nolag = (deploy[k] for k in
                  ("deployment_aggr_lagcomp", "deployment_aggr_nolagcomp"))
    print(f"AD aggressive A/B: lag compensation {lag['tracking_rmse_m']:.4f} m, "
          f"none {nolag['tracking_rmse_m']:.4f} m; published commands "
          f"{lag.get('result_age_p50_ticks')} and "
          f"{nolag.get('result_age_p50_ticks')} ticks old at p50 (max "
          f"{lag.get('result_age_max_ticks')}, {nolag.get('result_age_max_ticks')})")
    out["ad_path"] = {"oracle_u0_distance": d_oracle, "windowing_ms": win,
                      "closed_loop": {k: getattr(cl, k) for k in (
                          "rmse_pos", "mean_opt_ms", "p50_opt_ms", "p99_opt_ms",
                          "v_mean", "n_steps", "launches")},
                      "deployment": deploy}
    return cl.launches, total


ROW_KEYS = ("max_abs_err", "ms", "cold_ms", "plain_ms", "bound_ms", "bound_by",
            "registers", "spill_stores", "spill_loads")


def kernel_row(name, source, replaces, launches, r):
    """A kernel's entry of the ``{"kernels": [...]}`` line from its phase's
    numbers ``r``; fails when the kernel was not launched on its path or
    ran under its bound (its time is the cold one where there is one:
    a count that puts the bound above a measured time is wrong)."""
    check(launches > 0, f"{name}: no launch on its path")
    t = r.get("cold_ms", r["ms"])
    check(r["bound_ms"] <= t, f"{name}: {t:.5f} ms is under its bound "
          f"{r['bound_ms']:.5f} ms: the count is wrong")
    row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": launches, "library_ms": r.get("library_ms")}
    return row | {k: r[k] for k in ROW_KEYS if k in r}


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
    rk4 = phase_rk4(torch, np, out)
    lq = phase_lq(torch, np, out)
    launches = phase_slice(torch, out, card)
    vde_p = phase_vde_pacejka(torch, np, out)
    rk4_p = phase_rk4_pacejka(torch, np, out)
    launches_c4 = phase_c4(torch, out, card)
    vde_g = phase_vde_gp_bicycle(torch, np, out)
    rk4_g = phase_rk4_gp_bicycle(torch, np, out)
    launches_c3 = phase_c3(torch, out, card)
    vde_q = phase_vde_quad(torch, np, out)
    rk4_q = phase_rk4_quad(torch, np, out)
    lq_q = phase_lq_quad(torch, np, out)
    launches_q = phase_c5(torch, out, card)
    vde_gq = phase_vde_gp_quad(torch, np, out)
    rk4_gq = phase_rk4_gp_quad(torch, np, out)
    launches_c6 = phase_c6(torch, out, card)
    lane = phase_lane_chain(torch, out)
    lane_launches = phase_mxu(torch, out)
    phase_long_horizon(out)
    phase_c2_n40(torch, out, card)
    phase_latency(out)
    ad = phase_ad_kernels(torch, np, out)
    launches_cl, launches_dep = phase_ad_path(torch, np, out)

    vde_src, lq_src = "ad_mpc_tpu_torch/csrc/vde.cu", "ad_mpc_tpu_torch/csrc/lq_ipm.cu"
    vde_tpu = "ad_mpc_tpu/ops/pallas_vde.py:106"
    fused = ("ad_mpc_tpu/ocp/solver.py:464 and {} (the KKT defect and the "
             "plant step, which XLA fused in the jitted tick; no Pallas kernel)")
    rk4_c2, rk4_c5 = fused.format("bench.py:159"), fused.format(
        "ad_mpc_tpu/experiments/quad_fleet.py:143")
    kernels = [
        kernel_row("vde", vde_src, vde_tpu, launches["vde"], vde),
        kernel_row("rk4", vde_src, rk4_c2, launches["rk4"], rk4),
        kernel_row("lq_ipm", lq_src, "ad_mpc_tpu/ops/pallas_lq.py:485",
                   launches["lq_ipm"], lq),
        kernel_row("lane_chain", "ad_mpc_tpu_torch/csrc/lane_chain.cu",
                   "ad_mpc_tpu/experiments/mxu_riccati.py:135", lane_launches,
                   lane),
        kernel_row("vde_quad", vde_src, vde_tpu, launches_q["vde"], vde_q),
        kernel_row("rk4_quad", vde_src, rk4_c5, launches_q["rk4"], rk4_q),
        kernel_row("lq_ipm_13x4", "ad_mpc_tpu_torch/csrc/lq_ipm_wide.cuh",
                   "ad_mpc_tpu/ops/pallas_lq.py:468", launches_q["lq_ipm"], lq_q),
        kernel_row("vde_pacejka", vde_src, vde_tpu, launches_c4["vde"], vde_p),
        kernel_row("rk4_pacejka", vde_src, rk4_c2, launches_c4["rk4"], rk4_p),
        kernel_row("vde_gp_bicycle", vde_src, vde_tpu, launches_c3["vde"], vde_g),
        kernel_row("rk4_gp_bicycle", vde_src, rk4_c2, launches_c3["rk4"], rk4_g),
        kernel_row("vde_gp_quad", vde_src, vde_tpu, launches_c6["vde"], vde_gq),
        kernel_row("rk4_gp_quad", vde_src, rk4_c5, launches_c6["rk4"], rk4_gq),
    ]
    rk4_ad = ("ad_mpc_tpu/ocp/solver.py:250 and :263 (the line search's "
              "rollout_p and the KKT defect, XLA in the JAX solver; no Pallas "
              "kernel)")
    lq_ad = ("ad_mpc_tpu/ops/pallas_lq.py:485 (on this path the JAX solver "
             "runs the same function as the XLA IPM, ops/qp_ipm.py:207)")
    for N, launched in ((40, launches_cl), (20, launches_dep)):
        vde_r, rk4_r, lq_r = ad[N]
        kernels += [
            kernel_row(f"vde_ad_n{N}", vde_src, vde_tpu, launched["vde"], vde_r),
            kernel_row(f"rk4_ad_n{N}", vde_src, rk4_ad, launched["rk4"], rk4_r),
            kernel_row(f"lq_ipm_ad_n{N}", lq_src, lq_ad, launched["lq_ipm"], lq_r),
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
