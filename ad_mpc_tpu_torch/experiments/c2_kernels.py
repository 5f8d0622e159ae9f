"""Bits and device times of the c2 kernels (the bicycle VDE sweep and the
7x2 LQ kernel), bits of the c5 kernels (the quad VDE sweep, the quad RK4
map and the 13x4 LQ kernel), of the c3 and c4 functors (the GP-bicycle's
and the Pacejka's VDE sweep and RK4 map) of the c6 functor (the GP
quad's), of QuadMPC's drag and dual-state GP functors and of the other
functors (:func:`other_functor_bits`), device times of the 13x4 LQ
kernel, and the quad's and GP quads' sweeps' device times, resources and
RTI solves (:func:`quad_vde_ms`: the c5 and c6 functors, QuadMPC's drag,
dual-state and select GPs and the routed GP quad), the c3 and c4 sweeps'
device times and resources (:func:`c3_c4_vde_ms`), of whichever
``ad_mpc_tpu_torch`` is imported, so that two trees can be compared on one
card in one call:

    python ad_mpc_tpu_torch/experiments/c2_kernels.py [--out PATH]
    PYTHONPATH=<other tree> python ad_mpc_tpu_torch/experiments/c2_kernels.py

Run as a file, it imports the package from ``PYTHONPATH`` (or the working
directory), and uses only the c2 entry points of the package (none of the
quad's helpers but in :func:`c5_bits`, which needs a tree with the quad,
:func:`c3_c4_bits`, which needs one with the GP bicycle and the Pacejka,
and :func:`c6_bits`, which needs one with the GP quad and its fitted
model). Prints one JSON line: the package's path; the sha256 digests of
the kernels' outputs on the fixed draws of
``tests/test_torch_gpu.py:test_c2_kernels_keep_their_bits``,
``test_c5_kernels_keep_their_bits``, ``test_c3_c4_kernels_keep_their_bits``
and ``test_c6_kernels_keep_their_bits``;
QuadMPC's ``rdrv_d`` tracking row (:func:`rdrv_tracking`); device ms by
CUDA-graph replay (:func:`replay_ms`, written here with torch
alone so that it times an older tree too) at c2's B=16384 (the sweep on
``random_traj``, N=30; the 7x2 LQ kernel on the third c2 tick's QPs) and
of the 13x4 LQ kernel on the QPs of the third c5 tick at B=16384 and
B=1024, warm and cold (:func:`c5_lq_ms`).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

if __name__ == "__main__" and not os.environ.get("PYTHONPATH"):
    sys.path.insert(0, os.getcwd())

from ad_mpc_tpu_torch import fleet  # noqa: E402
from ad_mpc_tpu_torch.ops.cuda_lq import make_lq_solver  # noqa: E402
from ad_mpc_tpu_torch.ops.cuda_vde import make_vde  # noqa: E402
from ad_mpc_tpu_torch.testing import (  # noqa: E402
    BOUNDS, LQ_WEIGHTS, random_lq, random_traj)


def digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def c5_bits(dev):
    """Digests of the c5 kernels' outputs on fixed draws (B=37): the quad
    VDE sweep and both modes of its RK4 map on ``quad_traj`` (N=10), and the
    13x4 LQ kernel on random unit-box problems (18 iterations)."""
    from ad_mpc_tpu_torch.models.quadrotor import QuadDynamics
    from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4
    from ad_mpc_tpu_torch.testing import QUAD_LQ_WEIGHTS, quad_traj

    quad = QuadDynamics()
    xs, us = (torch.as_tensor(a, device=dev)
              for a in quad_traj(np.random.default_rng(8), 37, 10))
    ps = torch.zeros((37, 0), device=dev)
    vde = make_vde(quad, 0.1, 10, 13, 4, 0, device=dev)
    rk4 = make_rk4(quad, 0.1, 13, 4, 0, device=dev)
    Q, R = QUAD_LQ_WEIGHTS
    qp = make_lq_solver(10, 13, 4, Q, R, 10 * Q, *BOUNDS["unit"](13, 4),
                        iters=18, device=dev)
    args = [torch.as_tensor(a, device=dev)
            for a in random_lq(np.random.default_rng(7), 37, 10, 13, 4)]
    return {"vde_quad": digest(*vde(xs, us, ps)),
            "rk4_quad": digest(rk4.defect(xs, us, ps), rk4(xs[:, 0], us[:, 0], ps)),
            "lq_ipm_13x4": digest(*qp(*args))}


def c3_c4_bits(dev):
    """Digests of the c3 and c4 functors' outputs on the kernels' check
    inputs (B=37, N=30): the VDE sweep and both modes of the RK4 map of the
    GP bicycle (32 points) and of the Pacejka (p drawn as the fleet draws
    it)."""
    from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4
    from ad_mpc_tpu_torch.testing import gp_bicycle_inputs, pacejka_inputs

    out = {}
    for name, (dyn, (xs, us, ps)) in (("gp_bicycle", gp_bicycle_inputs(37, 30, dev)),
                                      ("pacejka", pacejka_inputs(37, 30, dev))):
        vde = make_vde(dyn, 0.05, 30, 7, 2, ps.shape[1], device=dev)
        rk4 = make_rk4(dyn, 0.05, 7, 2, ps.shape[1], device=dev)
        out[f"vde_{name}"] = digest(*vde(xs, us, ps))
        out[f"rk4_{name}"] = digest(rk4.defect(xs, us, ps),
                                    rk4(xs[:, 0], us[:, 0], ps))
    return out


def c6_bits(dev):
    """Digests of the c6 functor's outputs on the fixed draws of
    :func:`c5_bits` (B=37, N=10): the VDE sweep and both modes of the RK4
    map of the GP quad with the synthetic 32-point ensemble and with the
    fitted 60-point one."""
    from ad_mpc_tpu_torch.experiments import quad_fleet
    from ad_mpc_tpu_torch.models.gp_quad import GPQuadDynamics
    from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4
    from ad_mpc_tpu_torch.testing import quad_traj

    xs, us = (torch.as_tensor(a, device=dev)
              for a in quad_traj(np.random.default_rng(8), 37, 10))
    ps = torch.zeros((37, 0), device=dev)
    out = {}
    for name, ens in (("n32", quad_fleet.make_quad_gp_ensemble()),
                      ("fitted", quad_fleet.fitted_ensemble())):
        dyn = GPQuadDynamics(ens)
        vde = make_vde(dyn, 0.1, 10, 13, 4, 0, device=dev)
        rk4 = make_rk4(dyn, 0.1, 13, 4, 0, device=dev)
        out[f"vde_gp_quad_{name}"] = digest(*vde(xs, us, ps))
        out[f"rk4_gp_quad_{name}"] = digest(rk4.defect(xs, us, ps),
                                            rk4(xs[:, 0], us[:, 0], ps))
    return out


def quad_mpc_bits(dev):
    """Digests of QuadMPC's two functors' outputs on the fixed draws of
    :func:`c5_bits`: the RDRv drag and the dual-state GP (the fitted model,
    the trigger on every third scenario), the sweep and both modes of the
    RK4 map."""
    from ad_mpc_tpu_torch.experiments import quad_fleet
    from ad_mpc_tpu_torch.models.gp_quad import GPQuadDualDynamics
    from ad_mpc_tpu_torch.models.quadrotor import QuadDragDynamics
    from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4
    from ad_mpc_tpu_torch.testing import dual_gp_ps, quad_traj

    xs, us = (torch.as_tensor(a, device=dev)
              for a in quad_traj(np.random.default_rng(8), 37, 10))
    fitted = quad_fleet.fitted_ensemble()
    cases = {"drag": (QuadDragDynamics(quad_fleet.fitted_rdrv_d()),
                      torch.zeros((37, 0), device=dev)),
             "dual": (GPQuadDualDynamics(fitted), torch.as_tensor(
                 dual_gp_ps(np.random.default_rng(9), 37, fitted, 3), device=dev))}
    out = {}
    for name, (dyn, ps) in cases.items():
        vde = make_vde(dyn, 0.1, 10, 13, 4, ps.shape[1], device=dev)
        rk4 = make_rk4(dyn, 0.1, 13, 4, ps.shape[1], device=dev)
        out[f"vde_quad_{name}"] = digest(*vde(xs, us, ps))
        out[f"rk4_quad_{name}"] = digest(rk4.defect(xs, us, ps),
                                         rk4(xs[:, 0], us[:, 0], ps))
    return out


def other_functor_bits(dev):
    """Digests of the functors outside :func:`c3_c4_bits`, :func:`c6_bits`
    and :func:`quad_mpc_bits` (the VDE sweep and both modes of the RK4 map,
    B=37): the routed GP bicycle (its test ensemble, N=3), the routed GP
    quad and the dual-state GP with the fitted drag (the synthetic
    two-cluster ensemble, N=10), and the select functor on the fitted
    two-cluster model (nearest centroid, pinned to cluster 1, with the
    drag; states 1e-4 or more from a tie)."""
    from ad_mpc_tpu_torch.experiments import quad_fleet
    from ad_mpc_tpu_torch.experiments.routed_fleet import body_velocities
    from ad_mpc_tpu_torch.learned.lane import param_residual_dynamics
    from ad_mpc_tpu_torch.models.gp_quad import (
        GPQuadDualDynamics, GPQuadSelectDynamics)
    from ad_mpc_tpu_torch.models.quadrotor import QuadDynamics
    from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4
    from ad_mpc_tpu_torch.testing import (
        dual_gp_ps, margin_quad_traj, quad_traj, routed_bicycle_inputs)

    B = 37
    two = quad_fleet.make_quad_gp_ensemble(n=16, clusters=2)
    c2, D = quad_fleet.fitted_ensemble_c2(), quad_fleet.fitted_rdrv_d()
    xs, us = (torch.as_tensor(a, device=dev)
              for a in quad_traj(np.random.default_rng(17), B, 10))
    xs[..., 7:10] *= 10.0
    routed, _, pack = param_residual_dynamics(two, QuadDynamics(), 0, quad_frame=True)
    dyn, bxs, bus, bps = routed_bicycle_inputs(B, 3, dev)
    cases = {"gp_routed": (dyn, 0.05, (bxs, bus, bps)),
             "gp_quad_routed": (routed, 0.1, (xs, us, pack(body_velocities(xs[:, 0])))),
             "gp_quad_dual_drag": (GPQuadDualDynamics(two, rdrv_d=D), 0.1, (
                 xs, us, torch.as_tensor(dual_gp_ps(np.random.default_rng(2), B, two, 3),
                                         device=dev)))}
    for name, kw in (("c2", {}), ("c2_pinned", {"fixed_cluster": 1}),
                     ("c2_drag", {"rdrv_d": D})):
        sel = GPQuadSelectDynamics(c2, **kw)
        sxs, sus = (torch.as_tensor(a, device=dev) for a in margin_quad_traj(
            np.random.default_rng(B), B, 10, sel, 0.1))
        cases[f"gp_quad_select_{name}"] = (sel, 0.1, (sxs, sus, torch.zeros((B, 0),
                                                                            device=dev)))
    out = {}
    for name, (dyn, dt, (xs_, us_, ps_)) in cases.items():
        nx, nu = xs_.shape[-1], us_.shape[-1]
        vde = make_vde(dyn, dt, us_.shape[1], nx, nu, ps_.shape[1], device=dev)
        rk4 = make_rk4(dyn, dt, nx, nu, ps_.shape[1], device=dev)
        out[f"vde_{name}"] = digest(*vde(xs_, us_, ps_))
        out[f"rk4_{name}"] = digest(rk4.defect(xs_, us_, ps_),
                                    rk4(xs_[:, 0], us_[:, 0], ps_))
    return out


def c3_c4_vde_ms(dev):
    """The c3 GP bicycle's and the c4 Pacejka's sweeps (``GPBicycleDyn``
    with the bench's 32-point ensemble, ``PacejkaDyn`` with p as the fleet
    draws it, on the kernels' check inputs ``testing.gp_bicycle_inputs``
    and ``pacejka_inputs``, N=30): device ms by graph replay, warm and cold
    at B=16384 and warm at B=4096 (c4's fleet), with the RK4 map's defect
    warm at B=16384; each functor's registers and spills, and a team
    functor's geometry and blocks per SM (``occupancy``)."""
    from ad_mpc_tpu_torch.ops import _build
    from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4
    from ad_mpc_tpu_torch.testing import gp_bicycle_inputs, pacejka_inputs

    out = {}
    for name, inputs in (("gp_bicycle", gp_bicycle_inputs), ("pacejka", pacejka_inputs)):
        dyn, (xs, us, ps) = inputs(16384, 30, dev)
        vde = make_vde(dyn, 0.05, 30, 7, 2, ps.shape[1], device=dev)
        rk4 = make_rk4(dyn, 0.05, 7, 2, ps.shape[1], device=dev)
        run = lambda: vde(xs, us, ps)
        small = [t[:4096] for t in (xs, us, ps)]
        row = out[name] = {"ms": replay_ms(run), "cold_ms": replay_ms(run, cold=True),
                           "b4096_ms": replay_ms(lambda: vde(*small)),
                           "rk4_defect_ms": replay_ms(lambda: rk4.defect(xs, us, ps))}
        row |= _build.functor_resources(dyn.cuda_source, "vde_kernel", dyn.cuda_functor)
        if getattr(dyn, "cuda_team", False):
            row["blocks_per_sm"] = vde.occupancy(16384)
            row["geometry"] = vde.geometry(16384)._asdict()
    return out


def quad_solve_inputs(dev, kw):
    """A QuadMPC (N=10, 15 IPM iterations, ``kw`` its mode) on the loop at
    8 m/s, its reference and warm start as ``chip_smoke.py``'s
    ``quad_solve_case`` sets them, after one RTI solve: (the module, the
    sweep's inputs in that solve, a function that runs the solve again)."""
    from ad_mpc_tpu_torch.control.mpc import QuadMPC, quad_spec
    from ad_mpc_tpu_torch.experiments.quad_trajectory_test import (
        get_reference_chunk, reference)
    from ad_mpc_tpu_torch.ocp.solver import SolverState

    traj, t_ref, u_traj = reference("loop", 8.0)
    x_ref, u_ref = get_reference_chunk(traj, u_traj, t_ref, 6.0, 10, 0.1)
    x0 = torch.as_tensor(traj[300], dtype=torch.float32, device=dev)
    mpc = QuadMPC(spec=quad_spec(qp_iters=15), device=dev, backend="cuda", **kw)
    start = mpc.solver.init_state(x0)
    mpc.set_reference(x_ref, u_ref)
    mpc.state = SolverState(start.xs.clone(), start.us.clone())
    seen = []
    hook = mpc.solver.vde.register_forward_pre_hook(lambda m, a: seen.append(a))
    mpc.optimize(x0)
    hook.remove()
    st = SolverState(start.xs.clone(), start.us.clone())
    params = mpc._stage_params(x0, None)
    return mpc, seen[0], lambda: mpc.solver.solve(x0, mpc._yref_x, mpc._yref_u,
                                                  params, st)


def quad_vde_ms(dev):
    """The quad's and the GP quads' sweeps (``QuadDyn``, ``QuadDragDyn``,
    ``GPQuadDyn``, ``GPQuadDualDyn``, ``GPQuadDualDragDyn``,
    ``GPQuadSelectDyn``, ``GPQuadRoutedDyn``): device ms by graph replay,
    warm and cold, at B=16384, N=10 (c5's and c6's shapes, ``quad_traj``
    seed 13; the drag with the fitted D; the GP quad on the synthetic
    32-point and the fitted 60-point models; the dual-state GP on the
    fitted model, with and without the fitted drag, p drawn by
    ``testing.dual_gp_ps`` seed 31 with the trigger on every tenth
    scenario; the select GP on the fitted two-cluster ``gp_flagship_c2``,
    the velocities scaled by 5 across its clusters; the routed GP quad on
    ``gp_flagship_c2``, each scenario's p packed at its body velocity moved
    to a centroid of cluster b mod 2) and at B=1 on the inputs of QuadMPC's
    RTI solve in each mode (nominal; ``rdrv_d``; the one-cluster fitted
    ``quad_residual_fn``; ``ensemble=`` and ``ensemble=`` with ``rdrv_d``,
    as 10 one-stage scenarios; the two-cluster ``quad_residual_fn``, pinned
    to cluster 1, and the one-cluster one with ``rdrv_d``), with that
    solve's device ms; each functor's registers and spills, and a team
    functor's geometry and blocks per SM (``occupancy``)."""
    from ad_mpc_tpu_torch.experiments import quad_fleet
    from ad_mpc_tpu_torch.experiments.routed_fleet import body_velocities
    from ad_mpc_tpu_torch.learned.ensemble import quad_residual_fn
    from ad_mpc_tpu_torch.learned.lane import param_residual_dynamics
    from ad_mpc_tpu_torch.models.gp_quad import (
        GPQuadDualDynamics, GPQuadDynamics, GPQuadSelectDynamics)
    from ad_mpc_tpu_torch.models.quadrotor import QuadDragDynamics, QuadDynamics
    from ad_mpc_tpu_torch.ops import _build
    from ad_mpc_tpu_torch.testing import dual_gp_ps, quad_traj

    B = 16384
    xs, us = (torch.as_tensor(a, device=dev)
              for a in quad_traj(np.random.default_rng(13), B, 10))
    ps = torch.zeros((B, 0), device=dev)
    fitted, c2 = quad_fleet.fitted_ensemble(), quad_fleet.fitted_ensemble_c2()
    D = quad_fleet.fitted_rdrv_d()
    p_dual = torch.as_tensor(dual_gp_ps(np.random.default_rng(31), B, fitted), device=dev)
    routed, _, pack = param_residual_dynamics(c2, QuadDynamics(), 0, quad_frame=True)
    cen = torch.as_tensor(np.asarray(c2.centroids)[0], dtype=torch.float32, device=dev)
    p_routed = pack(body_velocities(xs[:, 0])
                    + cen[torch.arange(B, device=dev) % c2.n_clusters])
    out = {}
    for name, dyn, p, v in (
            ("quad", QuadDynamics(), ps, 1.0),
            ("quad_drag", QuadDragDynamics(D), ps, 1.0),
            ("gp_quad_n32", GPQuadDynamics(quad_fleet.make_quad_gp_ensemble()), ps, 1.0),
            ("gp_quad_fitted", GPQuadDynamics(fitted), ps, 1.0),
            ("gp_quad_dual_fitted", GPQuadDualDynamics(fitted), p_dual, 1.0),
            ("gp_quad_dual_drag_fitted", GPQuadDualDynamics(fitted, rdrv_d=D), p_dual, 1.0),
            ("gp_quad_select_c2", GPQuadSelectDynamics(c2), ps, 5.0),
            ("gp_quad_routed_c2", routed, p_routed, 1.0)):
        x = xs.clone()
        x[..., 7:10] *= v
        vde = make_vde(dyn, 0.1, 10, 13, 4, p.shape[1], device=dev)
        run = lambda: vde(x, us, p)
        row = out[name] = {"ms": replay_ms(run), "cold_ms": replay_ms(run, cold=True)}
        row |= _build.functor_resources(dyn.cuda_source, "vde_kernel", dyn.cuda_functor)
        if getattr(dyn, "cuda_team", False):
            row["blocks_per_sm"] = vde.occupancy(B)
            row["geometry"] = vde.geometry(B)._asdict()
    for name, kw in (("quad_b1_nominal", {}),
                     ("drag_b1_rdrv", {"rdrv_d": D}),
                     ("gp_quad_b1_residual_fn", {"residual_fn": quad_residual_fn(fitted)}),
                     ("dual_b1_ensemble", {"ensemble": fitted}),
                     ("dual_drag_b1_rdrv_gp", {"ensemble": fitted, "rdrv_d": D}),
                     ("select_b1_residual_fn_c2", {"residual_fn": quad_residual_fn(c2)}),
                     ("select_b1_residual_fn_c2_pinned",
                      {"residual_fn": quad_residual_fn(c2, 1)}),
                     ("select_b1_rdrv_residual_fn",
                      {"residual_fn": quad_residual_fn(fitted), "rdrv_d": D})):
        mpc, args, solve = quad_solve_inputs(dev, kw)
        run = lambda: mpc.solver.vde(*args)
        out[name] = {"ms": replay_ms(run), "cold_ms": replay_ms(run, cold=True),
                     "solve_ms": replay_ms(solve, 5), "functor": mpc.solver.f.cuda_functor}
        if getattr(mpc.solver.f, "cuda_team", False):
            out[name]["blocks_per_sm"] = mpc.solver.vde.occupancy(args[0].shape[0],
                                                                  args[1].shape[1])
    return out


def rdrv_tracking(dev):
    """QuadMPC's ``rdrv_d`` tracking row on the card (the fitted D, the loop
    at 8 m/s under the flagship's drag, 1,799 ticks, as ``chip_smoke.py``
    runs it): its RMSE in m, resets and opt-time p50 in ms."""
    from ad_mpc_tpu_torch.experiments import quad_fleet
    from ad_mpc_tpu_torch.experiments.quad_trajectory_test import run_tracking
    from ad_mpc_tpu_torch.sim.simulator import DisturbanceConfig

    r = run_tracking(disturbances=DisturbanceConfig(drag=True), device=dev,
                     rdrv_d=quad_fleet.fitted_rdrv_d())
    return {"rmse": r.rmse, "n_resets": r.n_resets, "n_steps": r.n_steps,
            "p50_opt_ms": r.p50_opt_ms}


FLUSH_BYTES = 128 * 2**20  # written before each call when cold (the L2 is 50 MB)


def replay_ms(fn, inner=10, cold=False, rounds=5):
    """Device ms per call of ``fn``: ``inner`` calls captured in one CUDA
    graph after a warm-up on a side stream, the least of ``rounds`` replays
    timed by CUDA events. ``cold``: ``FLUSH_BYTES`` written before each
    call in the graph, and a graph of the writes alone subtracted."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda") if cold else None

    def per_replay(body):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return min(times)

    def calls(with_fn):
        def body():
            for _ in range(inner):
                if cold:
                    flush.fill_(1.0)
                if with_fn:
                    fn()
        return body

    t = per_replay(calls(True))
    if cold:
        t -= per_replay(calls(False))
    return t / inner


def c5_lq_ms(dev):
    """The 13x4 LQ kernel on the QPs of the last QP of the third c5 tick at
    B=16384 and B=1024: ms warm and cold by graph replay."""
    from ad_mpc_tpu_torch.experiments import quad_fleet, tick_qp_inputs

    out = {}
    for B in (16384, 1024):
        tick, init, solver, _ = quad_fleet.build_quad_fleet(device=dev)
        args = tick_qp_inputs(tick, init, solver, B)
        run = lambda: solver.qp(*args)
        out[str(B)] = {"ms": replay_ms(run, 5), "cold_ms": replay_ms(run, 5, cold=True)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also append the JSON line to this file")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    bicycle = fleet.dynamic_bicycle
    res = {"package": os.path.dirname(fleet.__file__)}

    # The fixed draws of the bits test (B=37).
    xs, us = (torch.as_tensor(a, device=dev)
              for a in random_traj(np.random.default_rng(8), 37, 30, 7, 2))
    ps = torch.ones((37, 1), device=dev)
    vde = make_vde(bicycle, 0.05, 30, 7, 2, 1, device=dev)
    Q, R = LQ_WEIGHTS
    qp = make_lq_solver(30, 7, 2, Q, R, 1e-3 * Q, *BOUNDS["bicycle"](7, 2),
                        iters=12, device=dev)
    lq_args = [torch.as_tensor(a, device=dev)
               for a in random_lq(np.random.default_rng(7), 37, 30, 7, 2)]
    res["bits"] = {"vde": digest(*vde(xs, us, ps)), "lq_ipm": digest(*qp(*lq_args))}
    res["bits_c5"] = c5_bits(dev)
    res["bits_c3_c4"] = c3_c4_bits(dev)
    res["bits_c6"] = c6_bits(dev)
    res["bits_quad_mpc"] = quad_mpc_bits(dev)
    res["bits_others"] = other_functor_bits(dev)
    res["quad_vde"] = quad_vde_ms(dev)
    res["c3_c4_vde"] = c3_c4_vde_ms(dev)
    res["rdrv_tracking"] = rdrv_tracking(dev)

    # Device times at c2's B=16384.
    B = 16384
    xs, us = (torch.as_tensor(a, device=dev)
              for a in random_traj(np.random.default_rng(3), B, 30, 7, 2))
    ps = torch.ones((B, 1), device=dev)
    res["vde_ms"] = replay_ms(lambda: vde(xs, us, ps), 20)
    tick, init, solver, _ = fleet.build_fleet(bicycle, fleet.switch_on,
                                              device=dev)
    captured = []
    hook = solver.qp.register_forward_pre_hook(lambda m, a: captured.append(a))
    carry = init(B)
    for _ in range(3):
        carry, _ = tick(carry)
    hook.remove()
    res["lq_ipm_ms"] = replay_ms(lambda: solver.qp(*captured[-1]), 5)
    res["lq_ipm_13x4_c5_tick"] = c5_lq_ms(dev)
    res["device"] = torch.cuda.get_device_name(0)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main()
