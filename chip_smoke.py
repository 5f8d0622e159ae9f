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
   sequential recursion at N=30 and 128 (N=512 is left to the
   experiment's own command, to keep the smoke inside its time);
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
    A/B printed with the age of the published commands), and the
    aggressive pair again with each result held one tick
    (``result_delay_ticks=1``): commands two ticks old at p50, the JAX
    rows' age (checked), the comparison printed with its verdict (the
    JAX package's lag compensation wins there; on the card it has not:
    ROADMAP Queue C 2);
12. QuadMPC's functors at B=16384, N=10 on the quad phases' draws: the
    RDRv drag (``QuadDragDyn``, the fitted D) and the dual-state GP
    (``GPQuadDualDyn`` on the fitted 60-point model, held by ``anchored``,
    and on a synthetic two-cluster ensemble with each scenario's cluster
    read from its p; the trigger on every tenth scenario), each kernel
    against its plain version (3e-5), warm and cold, bound, registers and
    spills;
13. one quadrotor at B=1 (N=10, 15 IPM iterations) in each of QuadMPC's
    four modes (nominal, rdrv_d, quad_residual_fn of the fitted one-cluster
    GP, ensemble=): an RTI solve through the kernels against the plain
    solver on the card (u0 within 1e-3; one launch of each kernel), its
    time by graph replay and eager with the watchdog's fetch; kernel phases
    VDE and RK4 of each mode's functor on the inputs of its solve (B=1,
    N=10; the dual-state GP's N one-stage scenarios, B=10, N=1, with their
    trigger and cluster p rows) against their plain versions (3e-5; the
    fitted GP's modes by ``anchored``), warm and cold; then the 13x4 LQ
    kernel at B=1 on the solve's QP with 15 and 18 iterations (``lq_case``,
    strict), warm and cold;
14. the quadrotor tracking loop (``quad_trajectory_test.run_tracking``,
    loop at 8 m/s, 1,800 ticks) through the kernels: nominal, dual-state
    GP and RDRv under the flagship's drag and nominal without disturbance,
    each RMSE gated (1.25 x the JAX package's row; 0.24 m without
    disturbance) and printed beside the JAX row, the GP's cut against
    nominal at least 80%; the one-cluster quad_residual_fn under the drag,
    held to the same cut; opt-time p50/p99, resets and launches;
15. the fleet solver (``BatchedSQPSolver``) on the committed oracle
    instance at the c2 settings (12 IPM iterations, one RTI iteration,
    float32, N=20, broadcast p): |u0 - u0_oracle| < 1e-3;
16. the learned pipeline's recording (``experiments.record_dataset``) with
    the flagship's settings, its first 2 targets through QuadMPC on the
    card: the first 4 samples' x_in within 1e-3 of the committed
    recording's (later samples depend on rounding: ``RECORD_ROWS``), and
    the plant step and nominal prediction of every committed (x_in, u)
    within 1e-5 of its x_out and x_pred;
17. the fit (``gp_flagship.stage_fit``) on the committed recording: the 1-
    and 2-cluster candidates, their closed-loop validation through the
    card, the RDRv diagonal within 1e-6 of the JAX package's; the selected
    count, offline reduction and validation RMSEs beside the JAX fit's;
18. the parameter-routed GP functors against their plain versions:
    ``GPQuadRoutedDyn`` at B=16384, N=10 on the port's own two-cluster fit
    (both clusters in the launch; ``anchored``), ``GPRoutedDyn`` at the JAX
    test's shape (2e-5) and at B=16384, N=30 (2e-5), warm and cold,
    registers and spills;
19. the routed fleets: the quad fleet on the two-cluster fit (B=4096,
    three ticks, a cluster per scenario per tick) against the plain
    backend on the card (u0 within 1e-3, the fitted KKT gates), the
    carried one-cluster model routed against the c6-fitted tick (u0 within
    1e-5; the two functors' RK4 maps on the same states each held to the
    float64 plain version and within 1e-4 of each other), the routed GP bicycle in c2's fleet against plain; then one
    flagship sweep cell, the lemniscate at 6 m/s with the port's own fit
    (nominal, GP, RDRv; GP under nominal);
20. the quadrotor mission (``nodes/quad_node.py:QuadMissionNode`` on the
    card against the host plant, without disturbance): the JAX test's
    straight 2 m at 1 m/s (its gates) and the loop at 8 m/s through hover,
    ascend, track, land and off (RMSE under 1.25 x the JAX node's on the
    same script, ``JAX_MISSION_RMSE``), launches, solve p50/p99 with the
    fetch against the 20 ms period, and the host synchronisations of an
    optimized message (the node's one fetch, the watchdog's);
21. the two-node quad deployment over UDP (the JAX package's
    ``tests/test_quad_deployment.py`` scenario: drops every 17th message,
    the busy handshake), and a loop reference at 0.01 s through the
    bridge's fragments whole;
22. the fleet split over processes at c2's B=16384, N=30: one rank
    through ``nccl`` with the single-process tick's bits, two ranks
    sharing the card through ``gloo`` (u0 within 1e-6, the cross-rank KKT
    mean within 1e-6 relative), each rank's launches, and the
    shard-invariance ratio (``parallel.scaling``).

Each path of phases 4, 4a, 4b, 5, 5a, 7-11, 14, 16, 19 and 20-22 starts with its
kernels' launch counts at 0 and reads them after. The script then prints a
``{"kernels": [...]}`` line (each kernel's launches on its path, error,
times, bound and, for the VDE and RK4 rows, the registers and spills of
its functor's instantiation, matched by the functor's exact name; the
QuadMPC rows name their ``shape``: each mode's B=1 row, and the new
functors' B=16384 rows beside them with the tracking path's launches), failing
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
# (``csrc/vde_models.cuh:gp_quad_jacobian``): H = R G and dr/dv = H R^T, 9 dot
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


def functor_source(dyn):
    """The repo path of the source that holds ``dyn``'s functor."""
    return f"ad_mpc_tpu_torch/csrc/{dyn.cuda_source}.cu"


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
    ptxas = _build.ptxas_report(dyn.cuda_source)
    res = _build.functor_resources(dyn.cuda_source, "vde_kernel", dyn.cuda_functor)
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
        r["max_abs_err"] for r in rows.values()), "source": functor_source(dyn)}


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
    res = _build.functor_resources(dyn.cuda_source, "rk4_kernel", dyn.cuda_functor)
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
        r["max_abs_err"] for r in rows.values()), "source": functor_source(dyn)}


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
              f"{SPREAD_FACTOR}; plain on the CPU, first {row['control_B']}: "
              f"{row['control_factor']:.3f}); fixed-tolerance misses "
              f"{row['fixed_tol_misses']} (plain on the CPU, first "
              f"{row['control_B']}: {row['control_fixed_tol_misses']}); "
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

    res = long_horizon.micro(horizons=(30, 128))
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
                   "deployment_aggr_lagcomp": 0.160,
                   "deployment_aggr_nolagcomp_delay1": 2.780,
                   "deployment_aggr_lagcomp_delay1": 0.160}
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
    from ad_mpc_tpu_torch.bench import AD_GATES, DEPLOY_ROWS, lag_comp_ab
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
    # 24-27 ms over a 20 ms period: its commands were two ticks old at p50.
    # Here a result is back within its tick; the delay-1 rows hold each
    # result one more tick, the JAX rows' age (checked). Lag compensation
    # beating none there is the JAX result; on the H100 the rows tie at
    # that age too (ROADMAP Queue C 2, open), so the comparison is printed
    # with its verdict, as the port's bench reports it (bench.lag_comp_ab).
    for sfx in ("", "_delay1"):
        ab = lag_comp_ab(deploy, sfx)
        lag, nolag = ab["lagcomp"], ab["nolagcomp"]
        print(f"AD aggressive A/B{sfx or ' (delay 0)'}: lag compensation "
              f"{lag['tracking_rmse_m']:.4f} m, none {nolag['tracking_rmse_m']:.4f} "
              f"m; published commands {lag['result_age_p50_ticks']} and "
              f"{nolag['result_age_p50_ticks']} ticks old at p50 (max "
              f"{lag['result_age_max_ticks']}, {nolag['result_age_max_ticks']}"
              f"), unsafe ticks {lag['n_unsafe_ticks']} and {nolag['n_unsafe_ticks']}")
    for d in (lag, nolag):
        check(d["result_age_p50_ticks"] == 2.0, f"AD delay-1 rows: commands "
              f"{d['result_age_p50_ticks']} ticks old at p50, not the JAX rows' 2")
    print(f"AD aggressive A/B at the JAX rows' age: lag compensation "
          f"{lag['tracking_rmse_m']:.4f} m {'<' if ab['reproduced'] else '>='} none "
          f"{nolag['tracking_rmse_m']:.4f} m: the JAX result (2.780 against 0.160 m) "
          f"{'reproduced' if ab['reproduced'] else 'NOT reproduced (ROADMAP Queue C 2 open)'}")
    out["ad_path"] = {"oracle_u0_distance": d_oracle, "windowing_ms": win,
                      "closed_loop": {k: getattr(cl, k) for k in (
                          "rmse_pos", "mean_opt_ms", "p50_opt_ms", "p99_opt_ms",
                          "v_mean", "n_steps", "launches")},
                      "deployment": deploy, "aggr_ab_delay1": ab}
    return cl.launches, total


# Phases 12-15, QuadMPC and the quadrotor tracking loop: the two new
# functors, one RTI solve per mode at B=1, the tracking rows on the loop at
# 8 m/s (the JAX package's rows from
# results/experiments/gp_flagship/sweep_summary.json and README.md:105-106)
# and the fleet solver's oracle distance at the c2 settings. The sweep has
# no row of the one-cluster quad_residual_fn: that row is held to the GP's
# cut against nominal instead.
JAX_QUAD_RMSE = {"nominal": 0.32175934314727783, "gp": 0.02865125797688961,
                 "rdrv": 0.1170618012547493, "nominal_no_dist": 0.002,
                 "residual_fn": None}
QUAD_RMSE_GATES = {"nominal": 1.25 * 0.3218, "gp": 1.25 * 0.02865,
                   "rdrv": 1.25 * 0.1171, "nominal_no_dist": 0.24}
GP_REDUCTION_GATE = 0.80  # a GP row's RMSE cut against nominal
QUAD_QP_ITERS = 15  # quad_trajectory_test.run_tracking's
DUAL_TRIGGER_EVERY = 10  # node 0 of each N=10 horizon


def gp_quad_dual_flops(n, share, vde=True, nx=13, nu=4):
    """The least operations of one stage (``vde``) or one RK4 row of the
    dual-state GP quad when a ``share`` of the rows carries the trigger:
    those need no GP mean, and are counted at the quad's own (a floor under
    the rotations they do); the others as the GP quad's design needs them
    (:func:`gp_quad_vde_flops_per_stage`, :func:`gp_quad_rk4_flops_per_row`)
    at ``n`` points."""
    import torch

    from ad_mpc_tpu_torch.experiments.opcount import dyn_counts, rk4_flops
    from ad_mpc_tpu_torch.models.quadrotor import quad_dynamics_lane

    p = torch.zeros((1, 0))
    quad = lambda x, u, p: quad_dynamics_lane(x, u)
    if vde:
        gp, plain = gp_quad_vde_flops_per_stage(n), sweep_flops_per_stage(quad, nx, nu, p)
    else:
        gp, plain = (gp_quad_rk4_flops_per_row(n),
                     rk4_flops(dyn_counts(quad, nx, nu, p[0]), nx))
    return (1 - share) * gp + share * plain


def quad_functor_cases(torch, np, B):
    """{key: {name: (dynamics, ps)}} of the two new functors: the drag with
    the flagship's fitted D; the dual-state GP on the fitted 60-point model
    and on the synthetic two-cluster ensemble (each scenario's cluster read
    from its p), the trigger on every tenth scenario."""
    from ad_mpc_tpu_torch.experiments import quad_fleet
    from ad_mpc_tpu_torch.models.gp_quad import GPQuadDualDynamics
    from ad_mpc_tpu_torch.models.quadrotor import QuadDragDynamics
    from ad_mpc_tpu_torch.testing import dual_gp_ps

    dual = {}
    for name, ens in (("fitted n=60", quad_fleet.fitted_ensemble()),
                      ("two clusters n=32", quad_fleet.make_quad_gp_ensemble(
                          clusters=2))):
        ps = dual_gp_ps(np.random.default_rng(31), B, ens, DUAL_TRIGGER_EVERY)
        dual[name] = (GPQuadDualDynamics(ens), torch.as_tensor(ps, device="cuda"))
    return {"drag": {"fitted D": (QuadDragDynamics(quad_fleet.fitted_rdrv_d()),
                                  torch.zeros((B, 0), device="cuda"))},
            "dual": dual}


def phase_quad_functors(torch, np, out):
    """12. The drag and dual-state GP functors at B=16384, N=10 on the quad
    VDE and RK4 phases' draws: each against its plain version (3e-5; the
    fitted GP by ``anchored``), warm and cold, bound, registers and
    spills. Returns {row name: numbers}."""
    from ad_mpc_tpu_torch.testing import quad_traj

    B, N = 16384, 10
    share = 1.0 / DUAL_TRIGGER_EVERY
    cases = quad_functor_cases(torch, np, B)
    rows = {}
    for seed, kind in ((13, "vde"), (14, "rk4")):
        xs, us = (torch.as_tensor(a).cuda()
                  for a in quad_traj(np.random.default_rng(seed), B, N))
        if kind == "vde":
            rows["vde_quad_drag"] = vde_case(
                torch, out, "vde_quad_drag", cases["drag"], 0.1, xs, us, 3e-5)
            rows["vde_gp_quad_dual"] = vde_case(
                torch, out, "vde_gp_quad_dual", cases["dual"], 0.1, xs, us, 3e-5,
                gp_quad_dual_flops(60, share), anchor=("fitted n=60",))
        else:
            rows["rk4_quad_drag"] = rk4_case(
                torch, out, "rk4_quad_drag", cases["drag"], 0.1, xs, us, 3e-5)
            rows["rk4_gp_quad_dual"] = rk4_case(
                torch, out, "rk4_gp_quad_dual", cases["dual"], 0.1, xs, us, 3e-5,
                gp_quad_dual_flops(60, share, vde=False), anchor=("fitted n=60",))
    return rows


def quad_modes():
    """QuadMPC's four modes on the card, as the JAX package's callers use
    them: {name: QuadMPC keywords}."""
    from ad_mpc_tpu_torch.experiments import quad_fleet
    from ad_mpc_tpu_torch.learned.ensemble import quad_residual_fn

    fitted = quad_fleet.fitted_ensemble()
    return {"nominal": {}, "rdrv": {"rdrv_d": quad_fleet.fitted_rdrv_d()},
            "residual_fn": {"residual_fn": quad_residual_fn(fitted)},
            "ensemble": {"ensemble": fitted}}


def quad_solve_case(torch, out, mode, kw):
    """13. One quadrotor at B=1 (N=10, 15 IPM iterations) in ``mode``: an
    RTI solve through the kernels against the plain solver on the card from
    the same warm start (u0 within 1e-3; one launch of each kernel), the
    solve's device time by graph replay and its time eager with the
    watchdog's fetch and u0 on the host (host clock). Returns the solve's
    kernel inputs and modules: {"vde": (xs, us, ps), "qp": (QP inputs, QP
    module), "dyn": the dynamics, "dt": the stage length}."""
    from ad_mpc_tpu_torch import fleet
    from ad_mpc_tpu_torch.control.mpc import QuadMPC, quad_spec
    from ad_mpc_tpu_torch.experiments import graph_ms
    from ad_mpc_tpu_torch.experiments.quad_trajectory_test import (
        get_reference_chunk, reference)
    from ad_mpc_tpu_torch.ocp.solver import SolverState

    traj, t_ref, u_traj = reference("loop", 8.0)
    x_ref, u_ref = get_reference_chunk(traj, u_traj, t_ref, 6.0, 10, 0.1)
    x0 = torch.as_tensor(traj[300], dtype=torch.float32, device="cuda")
    kern, plain = (QuadMPC(spec=quad_spec(qp_iters=QUAD_QP_ITERS), device="cuda",
                           backend=b, **kw) for b in ("cuda", "plain"))
    start = plain.solver.init_state(x0)
    for m in (kern, plain):
        m.set_reference(x_ref, u_ref)
        m.state = SolverState(start.xs.clone(), start.us.clone())
    seen = {}
    hooks = [m.register_forward_pre_hook(lambda mod, a, k=k: seen.setdefault(k, a))
             for k, m in (("vde", kern.solver.vde), ("qp", kern.solver.qp))]
    try:
        zero_launches(kern.solver)
        got, _ = kern.optimize(x0)
        launches = fleet.launches(kern.solver)
    finally:
        for h in hooks:
            h.remove()
    want, _ = plain.optimize(x0)
    check(launches == {"vde": 1, "lq_ipm": 1, "rk4": 1},
          f"quad {mode}: launches per RTI solve {launches}")
    check(fleet.launches(plain.solver) == {"vde": 0, "lq_ipm": 0, "rk4": 0},
          f"quad {mode}: the plain solver launched a kernel")
    du0 = float((got[0] - want[0]).abs().max())
    check(du0 < 1e-3 and bool(got.isfinite().all()),
          f"quad {mode}: RTI u0 kernels vs plain {du0:.3e} >= 1e-3")
    st = SolverState(start.xs.clone(), start.us.clone())
    params = kern._stage_params(x0, None)
    row = {"u0_err": du0, "launches": launches,
           "graph_ms": graph_ms(lambda: kern.solver.solve(
               x0, kern._yref_x, kern._yref_u, params, st), inner=5)}
    for _ in range(3):
        kern.optimize(x0)[0][0].cpu()
    tic = time.perf_counter()
    for _ in range(20):
        kern.optimize(x0)[0][0].cpu()
    row["eager_fetch_ms"] = 1e3 * (time.perf_counter() - tic) / 20
    print(f"quad {mode} N=10 qp_iters={QUAD_QP_ITERS} B=1: RTI u0 kernels vs "
          f"plain {du0:.3e}; launches per solve {launches}; solve "
          f"{row['graph_ms']:.4f} ms by graph replay, {row['eager_fetch_ms']:.4f}"
          f" ms eager with the watchdog's fetch and u0 (host clock)")
    out.setdefault("quad_solve", {})[mode] = row
    return {"vde": seen["vde"], "qp": (seen["qp"], kern.solver.qp),
            "dyn": kern.solver.f, "dt": kern.spec.dt}


def phase_quad_kernels(torch, out):
    """13. Every mode's solve (:func:`quad_solve_case`); the VDE and RK4
    kernels of each mode's functor on the inputs that solve gave them (B=1,
    N=10; the dual-state GP's as N one-stage scenarios, B=10 and N=1, whose
    p rows carry the trigger and the cluster), each against its plain
    version (3e-5; the fitted GP's two modes by ``anchored``), warm and
    cold, registers and spills; then the 13x4 LQ kernel at B=1 on the
    nominal solve's QP, with 15 iterations (the tracking loop's) and 18
    (``quad_spec``'s default), each by ``lq_case`` (strict), warm and cold.
    Returns ({mode: (vde row, rk4 row)}, the 15-iteration LQ row)."""
    from ad_mpc_tpu_torch.control.mpc import quad_spec
    from ad_mpc_tpu_torch.ops.cuda_lq import make_lq_solver

    rows, qps = {}, {}
    for mode, kw in quad_modes().items():
        case = quad_solve_case(torch, out, mode, kw)
        (xs, us, ps), dyn, dt = case["vde"], case["dyn"], case["dt"]
        qps[mode] = case["qp"]
        # The bound as the functor's design needs it: the fitted GP's 60
        # points; the dual-state GP's trigger rows (this solve's share of
        # them) compute no GP mean.
        flops, anchor = (None, None), ()
        name = f"B={xs.shape[0]} N={xs.shape[1] - 1}"
        if mode == "residual_fn":
            flops = (gp_quad_vde_flops_per_stage(60), gp_quad_rk4_flops_per_row(60))
        elif mode == "ensemble":
            share = float((ps[:, 0] > 0.5).double().mean())
            flops = (gp_quad_dual_flops(60, share),
                     gp_quad_dual_flops(60, share, vde=False))
        if mode in ("residual_fn", "ensemble"):
            anchor = (name,)
        cases = {name: (dyn, ps)}
        rows[mode] = (
            vde_case(torch, out, f"vde_quad_mpc_{mode}", cases, dt, xs, us, 3e-5,
                     flops[0], anchor=anchor),
            rk4_case(torch, out, f"rk4_quad_mpc_{mode}", cases, dt, xs, us, 3e-5,
                     flops[1], anchor=anchor))
    args, qp15 = qps["nominal"]
    spec = quad_spec(qp_iters=18)
    Q, R, QN = spec.weight_arrays()
    qp18 = make_lq_solver(10, 13, 4, Q, R, QN, *spec.bound_dicts(), iters=18,
                          reg=spec.levenberg, device="cuda")
    lq = lq_cases(torch, out, "lq_13x4_b1",
                  {"quad_b1_15": (qp15, args, True),
                   "quad_b1_18": (qp18, args, True)},
                  cold=("quad_b1_15", "quad_b1_18"))
    for name, iters in (("quad_b1_15", 15), ("quad_b1_18", 18)):
        row = lq[name] | {"iters": iters,
                          "us_per_stage_iter": 1e3 * lq[name]["ms"] / (10 * iters)}
        lq[name] = row
        print(f"LQ 13x4 B=1 N=10 {iters} iterations: {row['ms']:.4f} ms warm, "
              f"{row['cold_ms']:.4f} ms cold, {row['us_per_stage_iter']:.3f} us "
              f"per stage-iteration warm")
    return rows, lq["quad_b1_15"]


def phase_quad_tracking(torch, out):
    """14. The loop at 8 m/s, all its ticks (1,800), through the kernels:
    nominal, dual-state fitted GP and fitted RDRv under the flagship's
    drag (deterministic), nominal without disturbance, and the fitted
    one-cluster ``quad_residual_fn`` under the drag (no JAX row: held to a
    GP's cut of the nominal RMSE); each RMSE against its gate and beside
    the JAX package's row, the dual-state GP's cut against nominal, the
    opt-time p50 and p99, the solver resets and the launches
    (per solve one of each kernel; the cold start's and each reset's N RK4
    rollout steps). Returns {row: launches}."""
    from ad_mpc_tpu_torch.experiments.quad_trajectory_test import run_tracking
    from ad_mpc_tpu_torch.sim.simulator import DisturbanceConfig

    modes = quad_modes()
    drag = DisturbanceConfig(drag=True)
    runs = {"nominal": (modes["nominal"], drag), "gp": (modes["ensemble"], drag),
            "rdrv": (modes["rdrv"], drag),
            "nominal_no_dist": (modes["nominal"], DisturbanceConfig()),
            "residual_fn": (modes["residual_fn"], drag)}
    rows = {}
    for name, (kw, dist) in runs.items():
        tic = time.perf_counter()
        r = run_tracking(disturbances=dist, device="cuda", **kw)
        wall = time.perf_counter() - tic
        n, L = r.n_steps + r.n_resets, r.launches
        check(L["vde"] == L["lq_ipm"] == n and L["rk4"] >= n + 10
              and (L["rk4"] - n) % 10 == 0,
              f"quad tracking {name}: launches {L} for {r.n_steps} ticks and "
              f"{r.n_resets} resets")
        gate = (QUAD_RMSE_GATES[name] if name in QUAD_RMSE_GATES
                else (1 - GP_REDUCTION_GATE) * rows["nominal"]["rmse"])
        check(r.rmse == r.rmse and r.rmse <= gate,
              f"quad tracking {name}: RMSE {r.rmse:.5f} m > {gate:.5f}")
        rows[name] = {"rmse": r.rmse, "jax_rmse": JAX_QUAD_RMSE[name],
                      "gate": gate, "p50_opt_ms": r.p50_opt_ms,
                      "p99_opt_ms": r.p99_opt_ms, "mean_opt_ms": r.mean_opt_ms,
                      "n_resets": r.n_resets, "n_steps": r.n_steps,
                      "v_max": r.v_max, "launches": L, "wall_s": wall}
        print(f"quad tracking loop @ 8 m/s {name}: RMSE {r.rmse:.5f} m (gate "
              f"{gate:.5f}; JAX package {JAX_QUAD_RMSE[name]}), {r.n_steps} "
              f"ticks, v_max {r.v_max:.2f} m/s, opt time p50 "
              f"{r.p50_opt_ms:.3f} ms p99 {r.p99_opt_ms:.3f} ms mean "
              f"{r.mean_opt_ms:.3f} ms (u0 on the host), resets {r.n_resets}, "
              f"launches {L}, {wall:.1f} s wall")
    cut = 1.0 - rows["gp"]["rmse"] / rows["nominal"]["rmse"]
    check(cut >= GP_REDUCTION_GATE, f"quad tracking: the GP cuts the nominal "
          f"RMSE by {100 * cut:.1f}% < {100 * GP_REDUCTION_GATE:.0f}%")
    print(f"quad tracking: the dual-state GP cuts the nominal RMSE by "
          f"{100 * cut:.1f}% (gate {100 * GP_REDUCTION_GATE:.0f}%; JAX package "
          f"{100 * (1 - JAX_QUAD_RMSE['gp'] / JAX_QUAD_RMSE['nominal']):.1f}%)")
    out["quad_tracking"] = rows | {"gp_reduction": cut}
    return {k: r["launches"] for k, r in rows.items()}


def phase_fleet_oracle(out):
    """15. Queue C 1: the committed oracle instance through the fleet solver
    at the c2 settings (12 IPM iterations, one RTI iteration, float32,
    N=20, broadcast p), 30 RTI re-solves: |u0 - u0_oracle| < 1e-3."""
    from ad_mpc_tpu_torch.testing import fleet_oracle_distance

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                           "fixtures", "oracle_bike_n20.npz")
    d, launches = fleet_oracle_distance(fixture, "cuda", backend="cuda")
    check(d < 1e-3, f"fleet oracle: |u0 - u0_oracle| {d:.3e} >= 1e-3")
    check(launches == {"vde": 30, "lq_ipm": 30, "rk4": 30},
          f"fleet oracle: launches {launches}")
    print(f"fleet oracle instance (BatchedSQPSolver, c2 settings, N=20, 30 RTI "
          f"re-solves, kernels): |u0 - u0_oracle| = {d:.3e} (gate 1e-3)")
    out["fleet_oracle_u0_distance"] = d


# Phases 16-19, the learned pipeline and the parameter-routed GP: the
# JAX package's committed flagship results (results/experiments/gp_flagship/)
# printed beside the port's.
FLAGSHIP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results",
                        "experiments", "gp_flagship")
JAX_FIT = {"n_clusters_selected": 1, "offline_reduction": 0.8274575533636365,
           "val_rmse_mean": {"1": 0.025655130855739117, "2": 0.05333729553967714},
           "rdrv_diag": (-0.9655376110631658, -0.8775265649938838,
                         -0.5502027999069717)}
JAX_LEMNISCATE_6 = {"nominal": 0.22278538346290588, "gp": 0.02669026143848896,
                    "rdrv": 0.11326860636472702}
RECORD_TOL = 1e-3  # |x_in - the committed recording's x_in|, the first rows
# The recorded flights are chaotic under rounding: the 12-iteration IPM
# stops short at the saturated input box, so the port's own float32 and
# float64 recordings differ by 0.03 in u at the second solve and 0.33 at
# the fourth. The samples that precede that (x_in of the first 4, from 3
# solves) are held to RECORD_TOL; the later ones are only printed, with
# each flight's end and speed beside the committed recording's. What is
# deterministic is held at every committed row: the plant step and the
# nominal prediction of each recorded (x_in, u) (REPLAY_TOL).
RECORD_ROWS = 4
# |port - committed| of x_out and x_pred replayed from the committed (x_in,
# u): the JAX package recorded in float32 (2.9e-6 and 6.7e-6 at most, on
# any host: the replay runs in float64 on the CPU).
REPLAY_TOL = 1e-5
RDRV_TOL = 1e-6  # the RDRv diagonal, a deterministic least-squares fit
ONE_CLUSTER_TOL = 1e-5  # routed one-cluster tick against GPQuadDyn's, u0
ROUTED_U0_TOL = 1e-3  # the routed fleet on the card against the plain backend


def smoke_results_root():
    """Where the smoke's pipeline phases write (a directory of the checkout
    that .gitignore lists)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_results")


def phase_record(np, out):
    """16. ``record_flights`` with the flagship's settings (box 6 m, drag,
    seed 0) for its first 2 targets through QuadMPC on the card: the first
    ``RECORD_ROWS`` samples' x_in against the committed recording's
    (``RECORD_TOL``), the rest's distance, speeds and flights printed beside
    it; the plant step and nominal prediction replayed from every
    committed (x_in, u) against its x_out and x_pred (``REPLAY_TOL``).
    Returns the recording controller's launches."""
    from ad_mpc_tpu_torch.experiments.record_dataset import (
        flight_segments, record_flights, replay)
    from ad_mpc_tpu_torch.sim.simulator import DisturbanceConfig

    arrays, mpc = record_flights(n_targets=2, box=6.0, disturbances=DisturbanceConfig(
        drag=True), seed=0, device="cuda", return_mpc=True)
    with np.load(os.path.join(FLAGSHIP, "dataset", "data.npz")) as z:
        committed = dict(z)
    ref = committed["x_in"]
    x_out, x_pred = replay(ref, committed["u"])
    replay_err = {k: float(np.nanmax(np.abs(got - committed[k])))
                  for k, got in (("x_out", x_out), ("x_pred", x_pred))}
    nan_rows = {k: np.isnan(got).any(1).tolist() == np.isnan(committed[k]).any(1).tolist()
                for k, got in (("x_out", x_out), ("x_pred", x_pred))}
    check(all(nan_rows.values()) and max(replay_err.values()) <= REPLAY_TOL,
          f"record: the committed rows replayed {replay_err} (> {REPLAY_TOL}), the "
          f"non-finite rows the same: {nan_rows}")
    print(f"record: the plant step and nominal prediction of all {len(ref)} committed "
          f"(x_in, u) within {replay_err} of its x_out and x_pred (tol {REPLAY_TOL})")
    flights = [{k: f[k] for k in ("samples", "end", "v_max")}
               for f in flight_segments(arrays, 2, 6.0)]
    flights_ref = [{k: f[k] for k in ("samples", "end", "v_max")}
                   for f in flight_segments(committed, 2, 6.0)]
    print(f"record: flights {flights}; the committed recording's first two {flights_ref}")
    m = len(arrays["x_in"])
    rows = np.abs(arrays["x_in"] - ref[:m]).max(axis=1)
    err = float(rows[:RECORD_ROWS].max())
    check(np.isfinite(arrays["x_pred"]).all(), "record: a non-finite prediction")
    check(err <= RECORD_TOL, f"record: x_in of the first {RECORD_ROWS} samples "
          f"{err:.3e} from the committed recording's (> {RECORD_TOL})")
    over = np.flatnonzero(rows > RECORD_TOL)
    speed = lambda x: np.linalg.norm(x[:, 7:10], axis=1)
    s = mpc.solver
    launches = {"vde": s.vde.launches, "lq_ipm": s.qp.launches, "rk4": s.rk4.launches}
    v, v_ref = speed(arrays["x_in"]), speed(ref[:m])
    print(f"record (2 targets, box 6 m, drag, seed 0): {m} samples, the first "
          f"{RECORD_ROWS} within {err:.3e} of the committed recording's x_in (tol "
          f"{RECORD_TOL}); first row over it {over[0] if len(over) else None}, "
          f"largest {float(rows.max()):.3f}; speed mean {v.mean():.3f} max "
          f"{v.max():.3f} m/s (the committed first {m} rows: {v_ref.mean():.3f}, "
          f"{v_ref.max():.3f}); launches {launches}")
    out["record"] = {"n_samples": m, "x_in_err": err, "launches": launches,
                     "replay_err": replay_err, "flights": flights,
                     "first_row_over": int(over[0]) if len(over) else None,
                     "v_mean": float(v.mean()), "v_max": float(v.max())}
    return launches


def phase_fit(np, out):
    """17. ``gp_flagship.stage_fit`` on the committed recording: prune,
    split, the 1- and 2-cluster GP candidates (host fit), each flown on the
    two validation cells through the card, the RDRv drag. The RDRv
    diagonal against the JAX package's (``RDRV_TOL``); the selected
    cluster count, offline reduction and validation RMSEs printed beside
    its. Returns (selected ensemble, rdrv_d, two-cluster candidate)."""
    import json as js

    from ad_mpc_tpu_torch.experiments.gp_flagship import stage_fit
    from ad_mpc_tpu_torch.utils import io

    root = smoke_results_root()
    ens, rdrv_d, meta = stage_fit("", n_clusters=2, n_points=60, n_restarts=3, seed=0,
                                  dataset=os.path.join(FLAGSHIP, "dataset"),
                                  device="cuda", root=root, verbose=False)
    with open(os.path.join(FLAGSHIP, "fit_meta.json")) as fh:
        jax_meta = js.load(fh)
    diag = np.diag(rdrv_d)
    d_err = float(np.abs(diag - np.asarray(jax_meta["rdrv_diag"])).max())
    check(d_err <= RDRV_TOL, f"fit: RDRv diagonal {diag} is {d_err:.3e} from the "
          f"JAX package's {jax_meta['rdrv_diag']} (> {RDRV_TOL})")
    cands = meta["candidates"]
    print(f"fit (committed recording): selected {meta['n_clusters_selected']} "
          f"cluster(s) (JAX {JAX_FIT['n_clusters_selected']}); offline reduction "
          f"{meta['reduction']:.4f} (JAX {JAX_FIT['offline_reduction']:.4f}); "
          + "; ".join(f"{k} cluster(s): offline {c['offline_reduction']:.4f}, "
                      f"validation RMSE {c['val_rmse']} mean {c['val_rmse_mean']:.5f} "
                      f"(JAX {JAX_FIT['val_rmse_mean'][k]:.5f})" for k, c in cands.items())
          + f"; RDRv diagonal {diag.tolist()} ({d_err:.1e} from the JAX package's)")
    out["fit"] = {"meta": meta, "rdrv_diag": diag.tolist(), "rdrv_err": d_err}
    two = io.load_model("gp_flagship_c2", root=root)
    return ens, rdrv_d, two


def routed_quad_case(torch, np, ens, B, N, seed):
    """(dynamics, xs, us, ps) of the routed body-frame GP of ``ens`` on
    the quad phases' draws; each scenario's p packed at its body velocity
    offset to the centroids of cluster b mod C, so that every cluster is
    present."""
    from ad_mpc_tpu_torch.experiments.routed_fleet import body_velocities
    from ad_mpc_tpu_torch.learned.lane import param_residual_dynamics
    from ad_mpc_tpu_torch.models.quadrotor import QuadDynamics
    from ad_mpc_tpu_torch.testing import quad_traj

    dyn, p_dim, pack = param_residual_dynamics(ens, QuadDynamics(), 0, quad_frame=True)
    xs, us = (torch.as_tensor(a).cuda() for a in quad_traj(np.random.default_rng(seed),
                                                           B, N))
    cen = torch.as_tensor(np.asarray(ens.centroids)[0], dtype=torch.float32,
                          device="cuda")
    z = body_velocities(xs[:, 0]) + cen[torch.arange(B, device="cuda") % ens.n_clusters]
    ps = pack(z)
    present = sorted(set(pack.clusters(z).flatten().tolist()))
    check(len(present) == ens.n_clusters, f"routed case: clusters {present} present")
    return dyn, xs, us, ps


def phase_routed_kernels(torch, np, out, two):
    """18. The routed functors against their plain versions: the body-frame
    GP (``GPQuadRoutedDyn``) at B=16384, N=10 on the port's own two-cluster
    fit, both clusters in the launch, each output held by ``anchored`` (the
    fitted tables' float32 rounding), warm and cold, registers and spills;
    the bicycle form (``GPRoutedDyn``) at the JAX package's test shape
    (B=4, N=3, its ensemble, both clusters) at 2e-5, then at B=16384, N=30
    on c2's draws with every other scenario's p on the other cluster
    (2e-5), timed. Returns {row: numbers}."""
    from ad_mpc_tpu_torch import fleet
    from ad_mpc_tpu_torch.learned.lane import param_residual_dynamics
    from ad_mpc_tpu_torch.models.bicycle import BicycleDynamics
    from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4, make_vde, vde_plain
    from ad_mpc_tpu_torch.ops.integrators import discrete_step
    from ad_mpc_tpu_torch.testing import routed_bicycle_ensemble, routed_bicycle_inputs

    B, N, n = 16384, 10, two.x_train.shape[2]
    rows = {}
    for seed, kind in ((13, "vde"), (14, "rk4")):
        dyn, xs, us, ps = routed_quad_case(torch, np, two, B, N, seed)
        cases = {"own fit, 2 clusters": (dyn, ps)}
        if kind == "vde":
            rows["vde_gp_routed_quad"] = vde_case(
                torch, out, "vde_gp_routed_quad", cases, 0.1, xs, us, 3e-5,
                gp_quad_vde_flops_per_stage(n), anchor=tuple(cases))
        else:
            rows["rk4_gp_routed_quad"] = rk4_case(
                torch, out, "rk4_gp_routed_quad", cases, 0.1, xs, us, 3e-5,
                gp_quad_rk4_flops_per_row(n), anchor=tuple(cases))
    # The JAX test's shape.
    dyn, xs, us, ps = routed_bicycle_inputs(4, 3, "cuda")
    vde = make_vde(dyn, 0.05, 3, 7, 2, dyn.p_dim, device="cuda")
    rk4 = make_rk4(dyn, 0.05, 7, 2, dyn.p_dim, device="cuda")
    got = (*vde(xs, us, ps), rk4.defect(xs, us, ps))
    want = (*vde_plain(dyn, 0.05, 1, xs, us, ps),
            discrete_step(dyn, 0.05, 1, xs[:, :-1], us, ps[:, None]) - xs[:, 1:])
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(err <= 2e-5, f"routed bicycle at the JAX test's shape: {err:.3e} > 2e-5")
    print(f"routed bicycle (GPRoutedDyn) at the JAX test's shape B=4, N=3, n=6, d=4: "
          f"VDE and RK4 defect within {err:.3e} of plain (2e-5)")
    ens = routed_bicycle_ensemble()
    dyn, p_dim, pack = param_residual_dynamics(ens, BicycleDynamics(), 1)
    for seed, kind in ((3, "vde"), (4, "rk4")):
        xs, us = c2_traj(torch, np, seed)
        z = xs[:, 0, 3:7].clone()
        z[1::2] = 0.0  # every other scenario on cluster 0
        ps = pack(z, torch.ones(1))
        check(len(set(pack.clusters(z).flatten().tolist())) == 2,
              "routed bicycle: both clusters present")
        cases = {"JAX test ensemble, 2 clusters": (dyn, ps)}
        args = (torch, out, f"{kind}_gp_routed_bicycle", cases, 0.05, xs, us, 2e-5)
        if kind == "vde":
            rows["vde_gp_routed_bicycle"] = vde_case(
                *args, gp_vde_flops_per_stage(fleet.dynamic_bicycle, ps[:, :1], 6, 2, 4))
        else:
            rows["rk4_gp_routed_bicycle"] = rk4_case(
                *args, gp_rk4_flops_per_row(fleet.dynamic_bicycle, ps[:, :1], 6, 2, 4))
    return rows


def phase_routed_fleet(torch, out, two):
    """19a. The routed fleets on the card: the quad fleet (c6's settings,
    B=4096) on the port's own two-cluster fit, each scenario's cluster
    picked per tick at its body velocity, c6's 20 warm-up ticks through
    the kernels, then three ticks through the kernels and through the
    plain backend on the card from that state (u0 within
    ``ROUTED_U0_TOL``, the fitted model's KKT gates, both clusters in use);
    the carried one-cluster fitted model routed against the c6-fitted tick
    through ``GPQuadDyn`` (u0 within ``ONE_CLUSTER_TOL``); the routed GP
    bicycle in c2's fleet (B=1024) against the plain backend. Returns
    {fleet: launches}."""
    from ad_mpc_tpu_torch import fleet
    from ad_mpc_tpu_torch.experiments import quad_fleet
    from ad_mpc_tpu_torch.experiments.routed_fleet import (
        LAUNCHES_PER_TICK, body_velocities, build_routed_quad_fleet)
    from ad_mpc_tpu_torch.learned.lane import param_residual_dynamics
    from ad_mpc_tpu_torch.models.bicycle import BicycleDynamics
    from ad_mpc_tpu_torch.models.gp_quad import GPQuadDynamics
    from ad_mpc_tpu_torch.models.quadrotor import QuadDynamics
    from ad_mpc_tpu_torch.testing import RK4_PAIR_TOL, routed_bicycle_ensemble, rk4_pair

    B, res = 4096, {}
    fleets = {backend: build_routed_quad_fleet(two, device="cuda", backend=backend)
              for backend in ("cuda", "plain")}
    tick, init, solver, _, pack = fleets["cuda"]
    zero_launches(solver)
    start = init(B)
    for _ in range(C5_WARMUP):  # c6's warm-up: the vehicles turn onto their circles
        start, _ = tick(start)
    runs = {}
    for backend, (tick, _, _, _, _) in fleets.items():
        carry, kkts, used = start, [], []
        for _ in range(3):
            used.append(pack.clusters(body_velocities(carry[0])))
            carry, (kkt, lat, p) = tick(carry)
            kkts.append(kkt)
        runs[backend] = (carry, torch.cat(kkts), used)
    (c_k, kkt_k, used), (c_p, kkt_p, _) = runs["cuda"], runs["plain"]
    launches = fleet.launches(solver)
    check_launches(LAUNCHES_PER_TICK, launches, C5_WARMUP + 3, "(routed quad fleet)")
    d_u0 = float((c_k[5].us[:, 0] - c_p[5].us[:, 0]).abs().max())
    g = quad_fleet.FITTED_GATES
    km, kx = float(kkt_k.mean()), float(kkt_k.max())
    counts = [torch.bincount(u.flatten(), minlength=two.n_clusters).tolist() for u in used]
    print(f"routed quad fleet (own 2-cluster fit, B={B}, {C5_WARMUP} warm-up ticks "
          f"then 3): u0 within {d_u0:.3e} of the plain backend (tol {ROUTED_U0_TOL}); "
          f"kkt mean {km:.3e} max {kx:.3e} (plain {float(kkt_p.mean()):.3e}, "
          f"{float(kkt_p.max()):.3e}; gates {g}); (scenario, output) pairs per "
          f"cluster by tick {counts}; launches {launches}")
    check(d_u0 <= ROUTED_U0_TOL, f"routed quad fleet: u0 {d_u0:.3e} from plain")
    check(km <= g["kkt_mean"] and kx <= g["kkt_max"],
          f"routed quad fleet: kkt mean {km:.3e} max {kx:.3e} over the gates {g}")
    check(all(min(c) > 0 for c in counts), f"routed quad fleet: clusters in use {counts}")
    res["quad"] = launches
    out["routed_fleet"] = {"u0_vs_plain": d_u0, "kkt_mean": km, "kkt_max": kx,
                           "cluster_counts": counts, "launches": launches}
    # One cluster: the routed tick is the c6-fitted tick.
    fitted = quad_fleet.fitted_ensemble()
    tick_r, init_r, _, _, _ = build_routed_quad_fleet(fitted, device="cuda")
    tick_b, init_b, _, _ = quad_fleet.build_quad_fleet(device="cuda", ensemble=fitted)
    c_r, _ = tick_r(init_r(B))
    c_b, _ = tick_b(init_b(B))
    d1 = float((c_r[5].us[:, 0] - c_b[5].us[:, 0]).abs().max())
    check(d1 <= ONE_CLUSTER_TOL, f"routed one-cluster tick: u0 {d1:.3e} from the "
          f"c6-fitted tick (> {ONE_CLUSTER_TOL})")
    print(f"routed one-cluster fitted model: one tick at B={B} gives the c6-fitted tick "
          f"through GPQuadDyn within {d1:.3e} on u0 (tol {ONE_CLUSTER_TOL})")
    out["routed_one_cluster_u0"] = d1
    # Their RK4 maps on the same states: each within float32 rounding of
    # the float64 plain version, and within RK4_PAIR_TOL of each other.
    dyn_r, _, pack_r = param_residual_dynamics(fitted, QuadDynamics(), 0, quad_frame=True)
    x, u = c_b[0], c_b[5].us[:, 0]
    diff, err_r, err_b, spread, held = rk4_pair(
        dyn_r, pack_r(body_velocities(x)), GPQuadDynamics(fitted),
        x.new_zeros((B, 0)), x, u, 0.1)
    check(held and diff <= RK4_PAIR_TOL, f"routed one-cluster RK4 map: {diff:.3e} from "
          f"GPQuadDyn's (tol {RK4_PAIR_TOL}), errors {err_r:.3e} and {err_b:.3e}, "
          f"float32 spread {spread:.3e}, both anchored: {held}")
    print(f"routed one-cluster RK4 map at B={B}: {diff:.3e} from GPQuadDyn's (tol "
          f"{RK4_PAIR_TOL}); against the float64 plain version {err_r:.3e} and "
          f"{err_b:.3e}, the float32 plain version's spread {spread:.3e} (both anchored)")
    out["routed_one_cluster_rk4"] = {"diff": diff, "err_routed": err_r,
                                     "err_baked": err_b, "spread": spread}
    # The routed GP bicycle in c2's fleet.
    ens = routed_bicycle_ensemble()
    dyn, _, pack_b = param_residual_dynamics(ens, BicycleDynamics(), 1)

    def p_of(v, kappa, extra):
        z = torch.tensor([v, 0.0, v * kappa, 0.0], dtype=torch.float64)
        return pack_b(z, torch.ones(1)).numpy()

    bike = {}
    for backend in ("cuda", "plain"):
        tick, init, solver, _ = fleet.build_fleet(dyn, p_of, device="cuda",
                                                  backend=backend)
        zero_launches(solver)
        carry = init(1024)
        for _ in range(3):
            carry, (kkt, lat) = tick(carry)
        bike[backend] = (carry, solver)
    d_b = float((bike["cuda"][0][5].us[:, 0] - bike["plain"][0][5].us[:, 0]).abs().max())
    check(d_b <= ROUTED_U0_TOL, f"routed bicycle fleet: u0 {d_b:.3e} from plain")
    res["bicycle"] = fleet.launches(bike["cuda"][1])
    check_launches(fleet.LAUNCHES_PER_TICK, res["bicycle"], 3, "(routed bicycle fleet)")
    print(f"routed GP bicycle in c2's fleet (B=1024, 3 ticks): u0 within {d_b:.3e} of "
          f"the plain backend; launches {res['bicycle']}")
    out["routed_bicycle_fleet_u0_vs_plain"] = d_b
    return res


def phase_flagship_cell(out, ens, rdrv_d):
    """19b. One sweep cell beyond phase 14's: the lemniscate at 6 m/s under
    drag, nominal, GP (QuadMPC's dual-state mode, the port's own fit) and
    RDRv (its own fit), through the card; the GP row under the nominal row,
    each beside the JAX package's cell."""
    import numpy as np

    from ad_mpc_tpu_torch.experiments.comparative import comparative_sweep

    rmse, t_opt, _ = comparative_sweep(
        {"nominal": {}, "gp": {"ensemble": ens}, "rdrv": {"rdrv_d": rdrv_d}},
        traj_types=("lemniscate",), speeds=(6.0,), device="cuda")
    r = dict(zip(("nominal", "gp", "rdrv"), rmse[:, 0, 0].tolist()))
    check(all(np.isfinite(v) for v in r.values()), f"flagship cell: {r}")
    check(r["gp"] < r["nominal"], f"flagship cell: GP {r['gp']:.5f} m not under "
          f"nominal {r['nominal']:.5f} m")
    print("flagship cell lemniscate @ 6 m/s (own fit): " + ", ".join(
        f"{k} {v:.5f} m (JAX {JAX_LEMNISCATE_6[k]:.5f})" for k, v in r.items())
        + f"; opt time means {t_opt[:, 0, 0].round(3).tolist()} ms")
    out["flagship_cell"] = {"rmse": r, "t_opt_ms": t_opt[:, 0, 0].tolist()}



# Phases 20-22, the quadrotor's mission and deployment nodes and the fleet
# split over processes. The loop mission's gate is 1.25 x the JAX
# package's mission node on the same script, run on the CPU
# (tests/test_torch_quad_node.py:test_jax_loop_mission_reference):
# 0.0012880157022161012 m without disturbance.
JAX_MISSION_RMSE = {"loop": 0.0012880157022161012}
MISSION_RMSE_GATES = {"straight": 0.5, "loop": 1.25 * JAX_MISSION_RMSE["loop"]}
QUAD_DEPLOY_BASE = 48900  # ports of the two-node quad loop, the next five


def phase_quad_mission(torch, np, out):
    """20. QuadMissionNode on the card (N=10, 1 s, 50 Hz, every second
    message optimized, recording on) against the host plant without
    disturbance: (a) the JAX test's straight 2 m at 1 m/s (10 IPM
    iterations; ascend, track and land seen, off below land_z + 0.1, RMSE <
    0.5 m, the recording's nominal prediction nearer the next state than
    standing still); (b) the loop at 8 m/s from ReferenceGenerator through
    hover -> ascend -> track -> land -> off at the default 18 IPM
    iterations, its RMSE under 1.25 x the JAX node's on the same script.
    Each with its launches and the solve time per optimized message by the
    host clock (the copies to the card and the fetch included; the whole
    message beside) against the 20 ms period; and the host
    synchronisations of an optimized message: the node's one fetch of u0
    and the predicted states, and QuadMPC's watchdog fetch. Returns the
    launches of both flights."""
    from ad_mpc_tpu_torch.control.mpc import QuadMPC, quad_spec
    from ad_mpc_tpu_torch.experiments.quad_mission import (
        ground_start, run_mission, straight_mission)
    from ad_mpc_tpu_torch.nodes.quad_node import MissionPhase, QuadMissionNode
    from ad_mpc_tpu_torch.nodes.reference_publisher import ReferenceGenerator
    from ad_mpc_tpu_torch.testing import mission_host_syncs

    rows, total = {}, {"vde": 0, "lq_ipm": 0, "rk4": 0}
    flights = {
        "straight": (QuadMissionNode(mpc=QuadMPC(spec=quad_spec(qp_iters=10),
                                                 device="cuda"), record=True),
                     *straight_mission(), 0),
        "loop": (QuadMissionNode(record=True, device="cuda"),
                 ReferenceGenerator(mode="loop", velocities=(8.0,)).next_trajectory(),
                 ground_start(), 50),
    }
    for name, (node, ref, x0, hover) in flights.items():
        s = node.mpc.solver
        s.vde.launches = s.qp.launches = s.rk4.launches = 0
        tic = time.perf_counter()
        res = run_mission(node, *ref, x0, hover_steps=hover, max_steps=4000)
        wall = time.perf_counter() - tic
        L = {"vde": s.vde.launches, "lq_ipm": s.qp.launches, "rk4": s.rk4.launches}
        n, resets = node.n_optimized, node.mpc.n_resets
        # Per solve one launch of each kernel (the RK4 map's: the KKT defect);
        # the cold start and each watchdog reset add the N=10 rollout.
        check(L["vde"] == L["lq_ipm"] == n + resets
              and L["rk4"] == n + resets + 10 * (1 + resets),
              f"mission {name}: launches {L} for {n} solves and {resets} resets")
        rmse, gate = node.tracking_rmse(), MISSION_RMSE_GATES[name]
        want = {"ascend", "track", "land", "off"} | ({"hover"} if hover else set())
        check(want <= res.seen, f"mission {name}: phases {sorted(res.seen)}")
        check(node.phase == MissionPhase.OFF and res.x_final[2] < node.land_z + 0.1,
              f"mission {name}: ends {node.phase.value} at z={res.x_final[2]:.3f}")
        check(rmse == rmse and rmse < gate, f"mission {name}: RMSE {rmse:.6f} m >= {gate}")
        x_in, _u, x_out, x_pred, _dt = node.recording_arrays()
        e_pred = float(np.linalg.norm(x_out - x_pred, axis=1).mean())
        e_hold = float(np.linalg.norm(x_out - x_in, axis=1).mean())
        check(e_pred < e_hold, f"mission {name}: nominal prediction {e_pred:.4f} "
              f"not nearer than standing still {e_hold:.4f}")
        p50, p99 = (float(v) for v in np.percentile(res.solve_ms[2:], [50, 99]))
        m50, m99 = (float(v) for v in np.percentile(res.step_ms[2:], [50, 99]))
        rows[name] = {"rmse": rmse, "gate": gate, "jax_rmse": JAX_MISSION_RMSE.get(name),
                      "phases": sorted(res.seen), "messages": res.n_steps,
                      "solves": node.n_optimized, "resets": node.mpc.n_resets,
                      "solve_p50_ms": p50, "solve_p99_ms": p99,
                      "message_p50_ms": m50, "message_p99_ms": m99,
                      "recorded_rows": len(x_in), "x_pred_err": e_pred,
                      "hold_err": e_hold, "launches": L, "wall_s": wall}
        total = {k: total[k] + v for k, v in L.items()}
        print(f"quad mission {name}: phases {sorted(res.seen)}, off at z="
              f"{res.x_final[2]:.4f} m after {res.n_steps} messages, RMSE {rmse:.6f} "
              f"m (gate {gate:.6f}; JAX node {JAX_MISSION_RMSE.get(name)}), "
              f"{node.n_optimized} solves, solve p50 {p50:.3f} ms p99 {p99:.3f} ms "
              f"with the copies and the fetch (message p50 {m50:.3f} ms p99 "
              f"{m99:.3f} ms; period 20 ms), resets {node.mpc.n_resets}, "
              f"{len(x_in)} recorded rows (prediction {e_pred:.4f} vs hold "
              f"{e_hold:.4f}), launches {L}, {wall:.1f} s wall")
        if m99 > 20.0:
            print(f"WARNING: mission {name} message p99 {m99:.2f} ms is over the period")
    node = QuadMissionNode(device="cuda")
    fetch, wd, rest, n_opt = mission_host_syncs(node, 12)
    check(n_opt == 6 and fetch == n_opt and wd == n_opt,
          f"mission syncs: {fetch} node fetches and {wd} watchdog fetches for "
          f"{n_opt} optimized messages; others {rest}")
    print(f"quad mission host synchronisations over {n_opt} optimized messages: "
          f"{fetch} fetches of u0 and the predicted states (one copy each), {wd} "
          f"watchdog fetches, others by site {rest}")
    out["quad_mission"] = rows | {"syncs": {"fetch": fetch, "watchdog": wd,
                                            "other": rest, "optimized": n_opt}}
    return total


def phase_quad_deploy(torch, np, out):
    """21. The JAX package's two-node quad scenario
    (``tests/test_quad_deployment.py:121-182``) on the card: the controller
    node (its mission on the card, 10 ms period), the plant node at 100 Hz
    dropping every 17th odometry message, and the reference publisher with
    hover, over the bridge: one reference sent and released by the busy
    handshake, more than 50 controller steps, drops seen, the quad above
    0.6 m at its peak; and a loop reference at the generator's 0.01 s
    (n x 17 float64s) through the bridge whole. Returns the launches."""
    import threading

    from ad_mpc_tpu_torch.nodes.quad_controller import QuadControllerNode, QuadSimNode
    from ad_mpc_tpu_torch.nodes.quad_node import QuadMissionNode
    from ad_mpc_tpu_torch.nodes.reference_publisher import (
        ReferenceGenerator, ReferencePublisherNode, decode_reference, encode_reference)
    from ad_mpc_tpu_torch.runtime import Publisher, Subscriber

    base = QUAD_DEPLOY_BASE
    mission = QuadMissionNode(n_nodes=10, t_horizon=1.0, control_period=0.01,
                              device="cuda")
    ctrl = QuadControllerNode(mission=mission, state_port=base, control_port=base + 1,
                              reference_port=base + 2, busy_port=base + 3)
    sim = QuadSimNode(rate_hz=100.0, state_port=base, control_port=base + 1,
                      drop_every=17)
    pub = ReferencePublisherNode(generator=ReferenceGenerator(mode="hover"),
                                 reference_port=base + 2, busy_port=base + 3)
    mission.step(sim.x.numpy(), 0.0, seq=0)  # the kernels' first launches
    mission._last_seq, mission._optimize_next, mission._msg_count = None, True, 0
    s = mission.mpc.solver
    s.vde.launches = s.qp.launches = s.rk4.launches = 0
    n0, r0 = mission.n_optimized, mission.mpc.n_resets
    t_ctrl = threading.Thread(target=ctrl.run, kwargs={"max_ticks": 500})
    t_sim = threading.Thread(target=sim.run, kwargs={"max_ticks": 600, "warmup": False})
    tic = time.perf_counter()
    try:
        t_ctrl.start()
        t_sim.start()
        sent = pub.run(max_trajectories=1, timeout_s=30.0)
        t_sim.join(timeout=60)
    finally:
        ctrl.stop()
        t_ctrl.join(timeout=30)
        ctrl.close()
        sim.close()
        pub.close()
    check(not t_sim.is_alive() and not t_ctrl.is_alive(),
          "quad deployment: a node's thread outlived its join")
    wall = time.perf_counter() - tic
    L = {"vde": s.vde.launches, "lq_ipm": s.qp.launches, "rk4": s.rk4.launches}
    n, resets = mission.n_optimized - n0, mission.mpc.n_resets - r0
    check(L["vde"] == L["lq_ipm"] == n + resets and L["rk4"] == n + 11 * resets,
          f"quad deployment: launches {L} for {n} solves and {resets} resets")
    z_max = float(np.stack(sim.states)[:, 2].max())
    check(sent == 1, f"quad deployment: {sent} references sent")
    check(ctrl.n_steps > 50, f"quad deployment: {ctrl.n_steps} controller steps")
    check(mission.n_skipped > 0, "quad deployment: no drop observed")
    check(z_max > 0.6, f"quad deployment: peak altitude {z_max:.3f} m <= 0.6")

    traj, t_ref, inputs = ReferenceGenerator(mode="loop").next_trajectory()
    msg = encode_reference(traj, t_ref, inputs)
    sub, p = Subscriber(base + 4), Publisher(base + 4)
    try:
        p.publish(7, msg)
        got = sub.receive(timeout_ms=2000)
    finally:
        sub.close()
        p.close()
    check(got is not None, "dense reference: nothing arrived")
    traj2, t2, inputs2 = decode_reference(got[1])
    check(np.array_equal(traj2, traj) and np.array_equal(inputs2, inputs)
          and float(np.abs(t2 - t_ref).max()) < 1e-12,
          "dense reference: the decoded arrays differ")
    row = {"sent": sent, "controller_steps": ctrl.n_steps, "solves": n,
           "resets": resets, "skipped": mission.n_skipped, "z_max": z_max,
           "phase": mission.phase.value, "launches": L, "wall_s": wall,
           "dense_reference_bytes": int(msg.nbytes), "dense_reference_rows": len(t_ref)}
    print(f"quad deployment (two nodes over UDP, drops every 17th): sent {sent}, "
          f"{ctrl.n_steps} controller steps, {n} solves, {mission.n_skipped} skipped "
          f"messages, peak z {z_max:.3f} m, ends {mission.phase.value}, launches {L}, "
          f"{wall:.1f} s wall; the loop reference ({len(t_ref)} rows, "
          f"{msg.nbytes} bytes) through the bridge whole")
    out["quad_deploy"] = row
    return L


def phase_multihost(torch, np, out, card):
    """22. The fleet split over processes at c2's full width (B=16384,
    N=30, 12 IPM iterations), 20 timed ticks: (a) one rank through an
    ``nccl`` group, its u0, shifted warm start and plant step bit for bit
    the single-process tick's; (b) two ranks sharing the card through a
    ``gloo`` group, 8,192 scenarios each, each rank's u0 within 1e-6 of the
    unsplit tick's on its scenarios and the cross-rank KKT mean within 1e-6
    relative of the unsplit mean; each rank's launches (per tick one VDE,
    one LQ, one RK4; the dump's plant step one more RK4); (c) the
    shard-invariance ratio (``parallel.scaling``). Returns the ranks'
    launches."""
    import shutil

    from ad_mpc_tpu_torch.parallel import scaling
    from ad_mpc_tpu_torch.parallel.multihost import launch, parse_line
    from ad_mpc_tpu_torch.testing import c2_tick_reference

    B, T = 16384, 20
    ref = c2_tick_reference(B, "cuda")
    dump_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                             "smoke_multihost")
    shutil.rmtree(dump_root, ignore_errors=True)
    rows, total = {}, {"vde": 0, "lq_ipm": 0, "rk4": 0}
    try:
        for name, procs, backend in (("nccl_1", 1, "nccl"), ("gloo_2", 2, "gloo")):
            dump = os.path.join(dump_root, name)
            tic = time.perf_counter()
            f = parse_line(launch(procs=procs, batch=B, nodes=30, qp_iters=12, ticks=T,
                                  device="cuda", backend=backend, scenario="c2",
                                  dump=dump, timeout=300.0))
            wall = time.perf_counter() - tic
            ranks = [np.load(os.path.join(dump, f"rank{r}.npz")) for r in range(procs)]
            per_rank = [dict(kv.split(":") for kv in part.split(","))
                        for part in f["launches"].split(";")]
            for r, L in enumerate(per_rank):
                L = {k: int(v) for k, v in L.items()}
                check(L == {"vde": T + 1, "lq_ipm": T + 1, "rk4": T + 2},
                      f"multihost {name} rank {r}: launches {L}")
                total = {k: total[k] + L[k] for k in total}
            if procs == 1:
                same = {k: bool(np.array_equal(ranks[0][k], ref[k]))
                        for k in ("u0", "next_xs", "next_us", "x_next")}
                check(all(same.values()), f"multihost {name}: bits differ from the "
                      f"single-process tick: {same}")
                d_u0 = 0.0
            else:
                d_u0 = max(float(np.abs(d["u0"] - ref["u0"][slice(*d["rows"])]).max())
                           for d in ranks)
                check(d_u0 <= 1e-6, f"multihost {name}: |u0 - unsplit| {d_u0:.3e} > 1e-6")
            kkt0 = float(f["kkt0"])
            rel = abs(kkt0 - ref["kkt_mean"]) / ref["kkt_mean"]
            check(rel <= 1e-6, f"multihost {name}: KKT mean {kkt0!r} vs unsplit "
                  f"{ref['kkt_mean']!r} ({rel:.2e} relative)")
            rows[name] = {"line": f, "u0_max_diff": d_u0, "kkt0": kkt0,
                          "kkt0_unsplit": ref["kkt_mean"], "kkt0_rel": rel,
                          "launches_per_rank": per_rank, "wall_s": wall}
            print(f"multihost {name} ({f['backend']}, {f['procs']} rank(s), B={B}, "
                  f"N=30): {f['solves_per_s']} solves/s over the ranks (per rank "
                  f"{f['per_rank_solves_per_s']}), u0 {'bits equal' if procs == 1 else f'within {d_u0:.2e}'} "
                  f"of the single-process tick, KKT mean {kkt0:.6e} vs {ref['kkt_mean']:.6e} "
                  f"({rel:.1e} relative), launches {f['launches']}, {wall:.1f} s wall")
    finally:
        shutil.rmtree(dump_root, ignore_errors=True)
    inv = scaling.measure_shard_invariance()
    print(f"shard invariance on {card} (B=16384, N=30, 12 IPM iterations, best of 3 x "
          f"10 ticks by CUDA events): a rank's tick with its per-tick KKT reduction "
          f"{inv['rank']['solves_per_s']:.0f} solves/s, the unsplit tick "
          f"{inv['plain']['solves_per_s']:.0f}, ratio {inv['rank_over_plain']:.4f}")
    out["multihost"] = rows | {"shard_invariance": inv}
    return total


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
    row = {"name": name, "route": "cuda", "source": r.get("source", source),
           "replaces": replaces,
           "launches": launches, "library_ms": r.get("library_ms")}
    return row | {k: r[k] for k in ROW_KEYS if k in r}


def quad_kernel_rows(quad_rows, quad_b1, lq_b1, track):
    """The kernels-line rows of QuadMPC's path (phases 12-14, 20, 21): each
    mode's VDE and RK4 rows at the shapes its solve gives them, with the
    launches of the tracking rows that run that mode (nominal: also the
    mission's and the two-node deployment's); the two new functors' rows at
    B=16384; the 13x4 LQ kernel at B=1."""
    vde_src = "ad_mpc_tpu_torch/csrc/vde.cuh"  # each row names its functor's source
    vde_tpu = "ad_mpc_tpu/ops/pallas_vde.py:106"
    rk4_quad_mpc = ("ad_mpc_tpu/ocp/solver.py:263 and :292 (the KKT defect and "
                    "the cold start's rollout, XLA in the JAX solver; no Pallas "
                    "kernel)")
    lq_quad_mpc = ("ad_mpc_tpu/ops/pallas_lq.py:468 (on this path the JAX solver "
                   "runs the same function as the XLA IPM, ops/qp_ipm.py:207)")
    mode_launches = {
        "nominal": {k: sum(track[r][k] for r in ("nominal", "nominal_no_dist",
                                                  "mission", "quad_deploy"))
                    for k in ("vde", "rk4")},
        "rdrv": track["rdrv"], "residual_fn": track["residual_fn"],
        "ensemble": track["gp"]}
    b1_shape = {"ensemble": "B=10, N=1 (the N one-stage scenarios of B=1, N=10)"}
    rows = []
    for mode, (vde_r, rk4_r) in quad_b1.items():
        shape = {"shape": b1_shape.get(mode, "B=1, N=10")}
        L = mode_launches[mode]
        rows += [
            kernel_row(f"vde_quad_mpc_{mode}", vde_src, vde_tpu, L["vde"], vde_r) | shape,
            kernel_row(f"rk4_quad_mpc_{mode}", vde_src, rk4_quad_mpc, L["rk4"],
                       rk4_r) | shape]
    # The two new functors at the quad phases' B=16384: the times of a
    # fleet's shapes; the launches are the same functor's on the tracking rows.
    big = {"shape": "B=16384, N=10 (launches: this functor's on the B=1 tracking rows)"}
    return rows + [
        kernel_row("vde_quad_drag_b16384", vde_src, vde_tpu,
                   track["rdrv"]["vde"], quad_rows["vde_quad_drag"]) | big,
        kernel_row("rk4_quad_drag_b16384", vde_src, rk4_quad_mpc,
                   track["rdrv"]["rk4"], quad_rows["rk4_quad_drag"]) | big,
        kernel_row("vde_gp_quad_dual_b16384", vde_src, vde_tpu,
                   track["gp"]["vde"], quad_rows["vde_gp_quad_dual"]) | big,
        kernel_row("rk4_gp_quad_dual_b16384", vde_src, rk4_quad_mpc,
                   track["gp"]["rk4"], quad_rows["rk4_gp_quad_dual"]) | big,
        kernel_row("lq_ipm_13x4_b1", "ad_mpc_tpu_torch/csrc/lq_ipm_wide.cuh",
                   lq_quad_mpc, sum(L["lq_ipm"] for L in track.values()), lq_b1)
        | {"shape": "B=1, N=10, 15 iterations"},
    ]


def timed(out, name, phase, *args):
    """``phase(*args)``, its wall time printed and kept in
    ``out["phase_s"]`` (the smoke's budget is 1,200 s, the build included)."""
    tic = time.perf_counter()
    res = phase(*args)
    sec = time.perf_counter() - tic
    out.setdefault("phase_s", {})[name] = sec
    print(f"phase {name}: {sec:.1f} s")
    return res


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
    vde = timed(out, "vde", phase_vde, torch, np, out)
    rk4 = timed(out, "rk4", phase_rk4, torch, np, out)
    lq = timed(out, "lq", phase_lq, torch, np, out)
    launches = timed(out, "slice", phase_slice, torch, out, card)
    vde_p = timed(out, "vde_pacejka", phase_vde_pacejka, torch, np, out)
    rk4_p = timed(out, "rk4_pacejka", phase_rk4_pacejka, torch, np, out)
    launches_c4 = timed(out, "c4", phase_c4, torch, out, card)
    vde_g = timed(out, "vde_gp_bicycle", phase_vde_gp_bicycle, torch, np, out)
    rk4_g = timed(out, "rk4_gp_bicycle", phase_rk4_gp_bicycle, torch, np, out)
    launches_c3 = timed(out, "c3", phase_c3, torch, out, card)
    vde_q = timed(out, "vde_quad", phase_vde_quad, torch, np, out)
    rk4_q = timed(out, "rk4_quad", phase_rk4_quad, torch, np, out)
    lq_q = timed(out, "lq_quad", phase_lq_quad, torch, np, out)
    launches_q = timed(out, "c5", phase_c5, torch, out, card)
    vde_gq = timed(out, "vde_gp_quad", phase_vde_gp_quad, torch, np, out)
    rk4_gq = timed(out, "rk4_gp_quad", phase_rk4_gp_quad, torch, np, out)
    launches_c6 = timed(out, "c6", phase_c6, torch, out, card)
    lane = timed(out, "lane_chain", phase_lane_chain, torch, out)
    lane_launches = timed(out, "mxu", phase_mxu, torch, out)
    timed(out, "long_horizon", phase_long_horizon, out)
    timed(out, "c2_n40", phase_c2_n40, torch, out, card)
    timed(out, "latency", phase_latency, out)
    ad = timed(out, "ad_kernels", phase_ad_kernels, torch, np, out)
    launches_cl, launches_dep = timed(out, "ad_path", phase_ad_path, torch, np, out)
    quad_rows = timed(out, "quad_functors", phase_quad_functors, torch, np, out)
    quad_b1, lq_b1 = timed(out, "quad_kernels", phase_quad_kernels, torch, out)
    launches_track = timed(out, "quad_tracking", phase_quad_tracking, torch, out)
    timed(out, "fleet_oracle", phase_fleet_oracle, out)
    launches_record = timed(out, "record", phase_record, np, out)
    ens_fit, rdrv_fit, two = timed(out, "fit", phase_fit, np, out)
    routed = timed(out, "routed_kernels", phase_routed_kernels, torch, np, out, two)
    launches_routed = timed(out, "routed_fleet", phase_routed_fleet, torch, out, two)
    timed(out, "flagship_cell", phase_flagship_cell, out, ens_fit, rdrv_fit)
    launches_mission = timed(out, "quad_mission", phase_quad_mission, torch, np, out)
    launches_qdep = timed(out, "quad_deploy", phase_quad_deploy, torch, np, out)
    launches_mh = timed(out, "multihost", phase_multihost, torch, np, out, card)
    launches = {k: launches[k] + launches_mh[k] for k in launches}  # c2's kernels

    vde_src, lq_src = "ad_mpc_tpu_torch/csrc/vde.cuh", "ad_mpc_tpu_torch/csrc/lq_ipm.cu"
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
    kernels += quad_kernel_rows(quad_rows, quad_b1, lq_b1, launches_track | {
        "mission": launches_mission, "quad_deploy": launches_qdep})
    rk4_routed = ("ad_mpc_tpu/ocp/solver.py:464 and ad_mpc_tpu/experiments/"
                  "quad_fleet.py:143 (the KKT defect and the plant step, XLA in the "
                  "JAX tick; no Pallas kernel)")
    for form, shape in (("quad", "B=16384, N=10, two clusters (launches: the routed "
                                 "quad fleet's, B=4096)"),
                        ("bicycle", "B=16384, N=30, two clusters (launches: the routed "
                                    "bicycle fleet's, B=1024)")):
        L = launches_routed[form]
        kernels += [
            kernel_row(f"vde_gp_routed_{form}", vde_src, vde_tpu, L["vde"],
                       routed[f"vde_gp_routed_{form}"]) | {"shape": shape},
            kernel_row(f"rk4_gp_routed_{form}", vde_src, rk4_routed, L["rk4"],
                       routed[f"rk4_gp_routed_{form}"]) | {"shape": shape}]
    check(launches_record["vde"] > 0, "record: no launch")
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
