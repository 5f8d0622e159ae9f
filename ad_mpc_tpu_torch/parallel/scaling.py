"""Scaling measurements of the split fleet (the counterpart of
``ad_mpc_tpu/parallel/scaling.py``).

- :func:`measure_shard_invariance`: on one GPU, a rank's tick (the
  :class:`BatchedSolver` step of a rank in a one-rank ``nccl`` group, with
  its per-tick diagnostics reduction) against the unsplit tick (the
  :class:`BatchedSQPSolver` solve and shift) at the same batch, c2's full
  width (B=16384, N=30, 12 IPM iterations), each timed by CUDA events. The
  rank steps its block with the unsplit solver, so the two differ by the
  reduction alone: the ratio is what that costs a rank.
- :func:`measure_gloo_dry_run`: the multi-process path on the CPU (``gloo``,
  the plain backend) at small sizes. It checks that the path runs and the
  ranks agree; its rates time-share the host's cores and are no scaling
  figure.

Every GPU row is one card's; scaling across cards is not measured.

    python -m ad_mpc_tpu_torch.parallel.scaling [--out PATH]

writes ``scaling.json`` under the port's results root (``results/torch``).
"""

from __future__ import annotations

import json
import os
import subprocess


# c2's full width, and the windows of the timing.
PER_RANK_BATCH, NODES, QP_ITERS = 16384, 30, 12
TICKS, ROUNDS = 10, 3


def measure_shard_invariance() -> dict:
    """Solves per second of the unsplit c2 tick (solve and shift) and of a
    rank's tick (the same step plus the per-tick diagnostics reduction: the
    KKT mean all-reduced over a one-rank ``nccl`` group and fetched to the
    host) on the card at the same batch, best of ``ROUNDS`` windows of
    ``TICKS`` ticks each, CUDA events around each window; their ratio and
    each one's launches. The two differ by that reduction alone, so the
    ratio is what the reduction costs a rank. Joins a one-rank group
    unless one is up (and leaves it as it found it)."""
    import torch
    import torch.distributed as dist

    from ad_mpc_tpu_torch import fleet
    from ad_mpc_tpu_torch.control.mpc import bicycle_spec
    from ad_mpc_tpu_torch.models.bicycle import BicycleDynamics
    from ad_mpc_tpu_torch.ocp.solver import BatchedSQPSolver
    from ad_mpc_tpu_torch.ops import _build
    from ad_mpc_tpu_torch.parallel.batch import BatchedSolver
    from ad_mpc_tpu_torch.parallel.mesh import free_port, init_group

    _build.require_card("cuda")
    own_group = not dist.is_initialized()
    if own_group:
        init_group("nccl", 1, 0, free_port())
    try:
        B = PER_RANK_BATCH
        spec = bicycle_spec(t_horizon=0.05 * NODES, n_nodes=NODES, qp_iters=QP_ITERS)
        carry = fleet.init_carry(B, NODES, fleet.switch_on, "cuda")
        _s0, (x0, yx, yu, p, st0) = fleet.tick_inputs(carry, NODES, spec.dt)
        plain = BatchedSQPSolver(spec, BicycleDynamics(), p_dim=1, device="cuda")
        rank = BatchedSolver(spec, BicycleDynamics(), p_dim=1, device="cuda",
                             group=dist.group.WORLD)

        def plain_tick(states):
            res = plain.solve(x0, yx, yu, p, states)
            return plain.shift(res.state), res.kkt_residual

        def rank_tick(states):
            _us, _xs, states, kkt = rank.step(x0, yx, yu, p, states)
            rank.kkt_mean(kkt)
            return states, kkt

        out = {"per_rank_batch": B, "n_nodes": NODES, "qp_iters": QP_ITERS,
               "ticks": TICKS, "rounds": ROUNDS}
        for label, tick, solver in (("plain", plain_tick, plain),
                                    ("rank", rank_tick, rank.solver)):
            states, kkt = tick(st0)
            torch.cuda.synchronize()
            solver.vde.launches = solver.qp.launches = solver.rk4.launches = 0
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            best = None
            for _ in range(ROUNDS):
                start.record()
                for _ in range(TICKS):
                    states, kkt = tick(states)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
                best = ms if best is None else min(best, ms)
            out[label] = {"solves_per_s": B * TICKS / (best / 1e3),
                          "tick_ms": best / TICKS, "kkt_mean": float(kkt.mean()),
                          "launches": fleet.launches(solver)}
        out["rank_over_plain"] = (out["rank"]["solves_per_s"]
                                  / out["plain"]["solves_per_s"])
        return out
    finally:
        if own_group:
            dist.destroy_process_group()


def measure_gloo_dry_run() -> list:
    """The multi-process path on the CPU at 16 scenarios per rank (the JAX
    worker's N=8, 6 IPM iterations, 5 ticks): one ``multihost.launch`` for
    1 and for 2 processes. A dry run: its rates share the host's cores and
    are no scaling figure."""
    from ad_mpc_tpu_torch.parallel.multihost import launch, parse_line

    rows = []
    for n in (1, 2):
        f = parse_line(launch(procs=n, batch=16 * n, nodes=8, qp_iters=6, ticks=5,
                              device="cpu"))
        rows.append({"procs": n, "batch": int(f["batch"]),
                     "solves_per_s": float(f["solves_per_s"]),
                     "kkt_mean": float(f["kkt"]), "label": "dry run (CPU, gloo)"})
    return rows


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None):
    import argparse

    from ad_mpc_tpu_torch.utils.io import results_root

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(results_root(), "scaling.json"))
    args = ap.parse_args(argv)
    out = {"card": card_name(), "shard_invariance": measure_shard_invariance(),
           "dry_run": measure_gloo_dry_run(),
           "note": "one H100; scaling across cards is not measured"}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
