"""The fleet split over processes (the counterpart of
``ad_mpc_tpu/parallel/multihost.py``).

Scenario-batch data parallelism needs no per-solve communication: each
rank owns a block of the global fleet (host-major, ``parallel/mesh.py``),
steps it on its own device through :class:`BatchedSolver`, and only the
diagnostics reductions (the mean KKT defect, the agreement checks, the
per-rank rates and launches) cross ranks through ``torch.distributed``.

    python -m ad_mpc_tpu_torch.parallel.multihost --procs 2 --batch 64 --device cpu
    python -m ad_mpc_tpu_torch.parallel.multihost --procs 1 --scenario c2 --batch 16384

spawns ``--procs`` worker processes (subprocesses, not forks), runs the
split fleet step in every rank, checks that the ranks agree on the global
inputs and on the reduced KKT mean, and prints rank 0's line::

    MULTIHOST_OK procs=2 devices=1 batch=64 solves_per_s=... kkt=... ...

with the devices the ranks stepped on (the CPU counts as one), the KKT mean of the last tick (``kkt``) and of the first (``kkt0``,
unrounded), the per-rank rates and the kernel launches. ``--device cuda`` (the
default) runs the kernels, one rank per GPU through ``nccl``; ``--backend
gloo`` lets ranks share one card. ``--device cpu`` is the ``gloo`` dry run
on the plain backend. The ``straight`` scenario is the JAX worker's (the
dynamic bicycle on straight references, N=8, 6 IPM iterations); ``c2`` is
the first tick of bench config c2 (``fleet.build_fleet``: arcs, N=30, 12
IPM iterations). ``--dump DIR`` writes each rank's first-tick u0, shifted
warm start, plant step and KKT to ``DIR/rank<r>.npz``. A worker that fails
makes the launcher raise; nothing falls back.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]


def straight_inputs(B: int, N: int, dt: float):
    """The JAX worker's global fleet: speeds from ``default_rng(0)`` on
    straight references, p = 1 (float32 numpy: x0, yref_x, yref_u, p)."""
    rng = np.random.default_rng(0)
    v = rng.uniform(4.0, 10.0, B)
    x0 = np.zeros((B, 7), np.float32)
    x0[:, 3] = v
    t = np.arange(N + 1) * dt
    yx = np.zeros((B, N + 1, 7), np.float32)
    yx[:, :, 0] = v[:, None] * t[None]
    yx[:, :, 3] = v[:, None]
    return x0, yx, np.zeros((B, N, 2), np.float32), np.ones((B, 1), np.float32)


def worker_main(argv=None):
    """One rank: join the group, step its block of the fleet, report."""
    import argparse

    import torch
    import torch.distributed as dist

    from ad_mpc_tpu_torch.parallel.mesh import (
        init_group, make_layout, make_layout_2d, rank_device)

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--hosts", type=int, default=1)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--qp-iters", type=int, default=6)
    ap.add_argument("--ticks", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--scenario", default="straight", choices=["straight", "c2"])
    ap.add_argument("--dump", default=None)
    ap.add_argument("--gp-quad", action="store_true")
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    layout = (make_layout_2d(args.hosts, args.procs // args.hosts)
              if args.hosts > 1 else make_layout(args.procs))
    if layout.world != args.procs:
        raise ValueError(f"{args.procs} processes do not fill {args.hosts} hosts")
    dev = rank_device(backend, args.device, layout.coords(args.pid)[1])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_group(backend, args.procs, args.pid, args.port)
    try:
        _run_rank(args, layout, dev, backend)
    finally:
        dist.destroy_process_group()


def _run_rank(args, layout, dev, backend):
    import torch
    import torch.distributed as dist

    from ad_mpc_tpu_torch import fleet
    from ad_mpc_tpu_torch.control.mpc import bicycle_spec
    from ad_mpc_tpu_torch.models.bicycle import BicycleDynamics
    from ad_mpc_tpu_torch.ocp.solver import SolverState
    from ad_mpc_tpu_torch.parallel.batch import BatchedSolver
    from ad_mpc_tpu_torch.parallel.mesh import shard_slice

    B, N = args.batch, args.nodes
    if args.scenario == "c2":
        spec = bicycle_spec(t_horizon=N * 0.05, n_nodes=N, qp_iters=args.qp_iters)
    else:
        spec = bicycle_spec(t_horizon=0.4, n_nodes=N, qp_iters=args.qp_iters)
    solver = BatchedSolver(spec, BicycleDynamics(), p_dim=1, device=dev,
                           group=dist.group.WORLD, layout=layout)
    rdev = solver.reduce_device
    if args.scenario == "c2":
        # The global fleet's first tick, as fleet.build_fleet's tick makes it.
        carry = fleet.init_carry(B, N, fleet.switch_on, dev)
        _s0, (*glob, gstates) = fleet.tick_inputs(carry, N, spec.dt)
    else:
        glob = [torch.as_tensor(a) for a in straight_inputs(B, N, spec.dt)]
    checksum = float(sum(a.double().sum() for a in glob))
    x0, yx, yu, p = (solver.local(a).to(dev).contiguous() for a in glob)
    inner = solver.solver
    inner.vde.launches = inner.qp.launches = inner.rk4.launches = 0
    if args.scenario == "c2":
        states = SolverState(*(solver.local(a).contiguous() for a in gstates))
    else:
        states = solver.init_states(x0)

    us, xs, states, kkt = solver.step(x0, yx, yu, p, states)
    kkt0_mean = solver.kkt_mean(kkt)  # the first tick's, over every rank
    if args.dump:
        x_next = inner.F(x0, us[:, 0].contiguous(), p)
        os.makedirs(args.dump, exist_ok=True)
        sl = shard_slice(B, args.pid, layout)
        np.savez(os.path.join(args.dump, f"rank{args.pid}.npz"),
                 u0=us[:, 0].cpu().numpy(), next_xs=states.xs.cpu().numpy(),
                 next_us=states.us.cpu().numpy(), x_next=x_next.cpu().numpy(),
                 kkt=kkt.cpu().numpy(), rows=np.array([sl.start, sl.stop]))

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier()  # every rank's timed window starts together
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    tic = time.perf_counter()
    for _ in range(args.ticks):
        us, xs, states, kkt = solver.step(x0, yx, yu, p, states)
    if dev.type == "cuda":
        end.record()
        end.synchronize()
        window_s = start.elapsed_time(end) / 1e3
    else:
        window_s = time.perf_counter() - tic
    b_local = x0.shape[0]
    kkt_mean = solver.kkt_mean(kkt)
    if not bool(torch.isfinite(us).all()):
        raise RuntimeError(f"rank {args.pid}: non-finite controls")

    # Agreement: every rank drew the same global fleet and holds the same
    # reduced mean; and the per-rank rates and launches, one row per rank.
    world = layout.world
    agree = torch.tensor([checksum, kkt_mean, -checksum, -kkt_mean],
                         dtype=torch.float64, device=rdev)
    dist.all_reduce(agree, op=dist.ReduceOp.MAX)
    if not (agree[0] == -agree[2] and agree[1] == -agree[3]):
        raise RuntimeError(f"rank {args.pid}: ranks disagree: {agree.tolist()}")
    L = fleet.launches(inner)
    rows = torch.zeros((world, 6), dtype=torch.float64, device=rdev)
    rows[args.pid] = torch.tensor([b_local * args.ticks / window_s, window_s,
                                   L["vde"], L["lq_ipm"], L["rk4"],
                                   dev.index if dev.type == "cuda" else -1],
                                  dtype=torch.float64)
    dist.all_reduce(rows)
    rows = rows.cpu().numpy()

    gp = ""
    if args.gp_quad:
        gp = " " + _gp_quad_dry_step(dev, world, solver)
    if args.pid == 0:
        aggregate = B * args.ticks / rows[:, 1].max()
        per_rank = ",".join(f"{r:.1f}" for r in rows[:, 0])
        launches = ";".join(f"vde:{int(r[2])},lq_ipm:{int(r[3])},rk4:{int(r[4])}"
                            for r in rows)
        gpus = torch.cuda.device_count() if dev.type == "cuda" else 0
        devices = len(set(rows[:, 5]))
        print(f"MULTIHOST_OK procs={world} devices={devices} gpus={gpus} batch={B} "
              f"solves_per_s={aggregate:.1f} kkt={kkt_mean:.6e} kkt0={kkt0_mean!r} "
              f"backend={backend} "
              f"device={dev.type} layout={layout.n_hosts}x{layout.per_host} "
              f"scenario={args.scenario} nodes={N} qp_iters={args.qp_iters} "
              f"ticks={args.ticks} per_rank_solves_per_s={per_rank} "
              f"launches={launches}{gp}", flush=True)


def _gp_quad_dry_step(dev, world, bicycle_solver) -> str:
    """The dry run's learned-model fleet (``__graft_entry__.py``'s second
    half): the quad with the synthetic 8-point GP residual, two warm steps
    of each rank's block of 2 x world hovering scenarios; returns its
    ``gp_kkt=`` field."""
    import torch

    from ad_mpc_tpu_torch.control.mpc import quad_spec
    from ad_mpc_tpu_torch.experiments.quad_fleet import make_quad_gp_ensemble
    from ad_mpc_tpu_torch.models.gp_quad import GPQuadDynamics
    from ad_mpc_tpu_torch.models.quadrotor import hover_input
    from ad_mpc_tpu_torch.parallel.batch import BatchedSolver

    qspec = quad_spec(t_horizon=0.4, n_nodes=4, qp_iters=6, sqp_iters=2)
    gp = BatchedSolver(qspec, GPQuadDynamics(make_quad_gp_ensemble(n=8)), p_dim=0,
                       device=dev, group=bicycle_solver.group,
                       layout=bicycle_solver.layout)
    B, Nq = 2 * world, qspec.n_nodes
    x0 = torch.zeros((B, 13))
    x0[:, 3] = 1.0
    x0 = gp.local(x0).to(dev)
    yq = x0[:, None].expand(-1, Nq + 1, -1).contiguous()
    yuq = torch.as_tensor(hover_input(), dtype=torch.float32, device=dev).expand(
        x0.shape[0], Nq, -1).contiguous()
    pq = x0.new_zeros((x0.shape[0], 0))
    st = gp.init_states(x0)
    for _ in range(2):
        usq, _xs, st, kktq = gp.step(x0, yq, yuq, pq, st)
    if not bool(torch.isfinite(usq).all()):
        raise RuntimeError("GP-quad dry step: non-finite controls")
    return f"gp_kkt={gp.kkt_mean(kktq):.6e}"


def launch(procs: int = 2, batch: int = 64, nodes: int = 8, qp_iters: int = 6,
           ticks: int = 5, device: str = "cuda", backend: str | None = None,
           hosts: int = 1, scenario: str = "straight", dump: str | None = None,
           gp_quad: bool = False, timeout: float = 600.0) -> str:
    """Spawn the ranks and return rank 0's ``MULTIHOST_OK`` line. Raises
    when a worker fails or the run outlasts ``timeout`` seconds; every
    worker is stopped before it returns."""
    from ad_mpc_tpu_torch.parallel.mesh import free_port

    if device == "cuda":
        # Build the fleet's kernels once here; the workers load them.
        from ad_mpc_tpu_torch.ops import _build

        _build.require_card("cuda")
        _build.build_all(("vde_bicycle", "lq_ipm"))
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    cmd = [sys.executable, "-m", "ad_mpc_tpu_torch.parallel.multihost", "--worker",
           "--port", str(port), "--procs", str(procs), "--hosts", str(hosts),
           "--batch", str(batch), "--nodes", str(nodes), "--qp-iters", str(qp_iters),
           "--ticks", str(ticks), "--device", device, "--scenario", scenario]
    if backend is not None:
        cmd += ["--backend", backend]
    if dump is not None:
        cmd += ["--dump", str(dump)]
    if gp_quad:
        cmd += ["--gp-quad"]
    workers, outs, readers = [], [], []
    for pid in range(procs):
        w = subprocess.Popen(cmd + ["--pid", str(pid)], env=env, cwd=str(REPO),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        buf: list[str] = []
        r = threading.Thread(target=lambda f=w.stdout, b=buf: b.extend(f), daemon=True)
        r.start()
        workers.append(w)
        outs.append(buf)
        readers.append(r)
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(w.poll() is None for w in workers):
            bad = [i for i, w in enumerate(workers) if w.poll() not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"multihost: the workers outlasted {timeout} s")
            time.sleep(0.05)
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
            w.wait()
        for r in readers:
            r.join(timeout=5)
    for i, w in enumerate(workers):
        if failed is None and w.returncode != 0:
            failed = i
    if failed is not None:
        raise RuntimeError(f"multihost worker {failed} rc={workers[failed].returncode}:"
                           f"\n{''.join(outs[failed])[-3000:]}")
    for line in "".join(outs[0]).splitlines():
        if line.startswith("MULTIHOST_OK"):
            return line
    raise RuntimeError("no MULTIHOST_OK line:\n" + "".join(outs[0])[-3000:])


def parse_line(line: str) -> dict:
    """The ``key=value`` fields of a ``MULTIHOST_OK`` line."""
    return dict(kv.split("=", 1) for kv in line.split()[1:])


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--hosts", type=int, default=1,
                    help="hosts of the 2-D layout (host x ranks per host)")
    ap.add_argument("--batch", type=int, default=64, help="the global batch")
    ap.add_argument("--nodes", type=int, default=None,
                    help="horizon nodes (8 straight, 30 c2)")
    ap.add_argument("--qp-iters", type=int, default=None,
                    help="IPM iterations (6 straight, 12 c2)")
    ap.add_argument("--ticks", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--scenario", default="straight", choices=["straight", "c2"])
    ap.add_argument("--dump", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    c2 = args.scenario == "c2"
    print(launch(procs=args.procs, batch=args.batch,
                 nodes=args.nodes or (30 if c2 else 8),
                 qp_iters=args.qp_iters or (12 if c2 else 6), ticks=args.ticks,
                 device=args.device, backend=args.backend, hosts=args.hosts,
                 scenario=args.scenario, dump=args.dump, timeout=args.timeout))


if __name__ == "__main__":
    if "--worker" in sys.argv:
        sys.argv.remove("--worker")
        worker_main()
    else:
        main()
