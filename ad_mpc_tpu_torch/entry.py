"""Entry points of the port (the counterpart of ``__graft_entry__.py``):
one batch-1 SQP-RTI solve of the bicycle OCP, and the multi-process dry run.

    python -m ad_mpc_tpu_torch.entry              # the solve, on the card
    python -m ad_mpc_tpu_torch.entry multichip 4  # 4 gloo processes on the CPU
"""

from __future__ import annotations


def entry(device="cuda"):
    """One SQP-RTI solve of the dynamic-bicycle OCP (N=20, 10 IPM
    iterations) on ``device`` (the card by default). Returns
    (fn, example_args); fn(*example_args) -> (us (N, 2), xs (N+1, 7))."""
    import torch

    from ad_mpc_tpu_torch.control.mpc import bicycle_spec
    from ad_mpc_tpu_torch.models.bicycle import BicycleDynamics
    from ad_mpc_tpu_torch.ocp.solver import SolverState, SQPSolver

    spec = bicycle_spec(t_horizon=1.0, n_nodes=20, qp_iters=10)
    solver = SQPSolver(spec, BicycleDynamics(), p_dim=1, device=device)
    N = spec.n_nodes
    x0 = torch.zeros(7, device=device)
    x0[3] = 8.0
    t = torch.arange(N + 1, dtype=torch.float32, device=device) * spec.dt
    yref_x = torch.zeros((N + 1, 7), device=device)
    yref_x[:, 0] = 8.0 * t
    yref_x[:, 3] = 8.0
    yref_u = torch.zeros((N, 2), device=device)
    params = torch.ones(1, device=device)
    state = SolverState(xs=x0[None].expand(N + 1, -1).contiguous(),
                        us=torch.zeros((N, 2), device=device))

    def fn(x0, yref_x, yref_u, params, state):
        res = solver.solve(x0, yref_x, yref_u, params, state)
        return res.us, res.xs

    return fn, (x0, yref_x, yref_u, params, state)


def dryrun_multichip(n_procs: int, timeout: float = 300.0) -> str:
    """The split fleet step over ``n_procs`` gloo processes on the CPU at
    tiny shapes (batch 2 per rank, N=8, 4 IPM iterations), on the 2-D
    (host x rank) layout when ``n_procs`` is even and over 2, plus the
    GP-quad fleet's two warm steps. Returns rank 0's line."""
    from ad_mpc_tpu_torch.parallel.multihost import launch, parse_line

    hosts = 2 if n_procs % 2 == 0 and n_procs > 2 else 1
    line = launch(procs=n_procs, batch=2 * n_procs, nodes=8, qp_iters=4, ticks=1,
                  device="cpu", hosts=hosts, gp_quad=True, timeout=timeout)
    f = parse_line(line)
    print(f"dryrun_multichip OK: {n_procs} processes (layout {f['layout']}), "
          f"batch {f['batch']}, mean kkt defect {f['kkt']}, GP-quad fleet mean "
          f"kkt defect {f['gp_kkt']}")
    return line


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "multichip":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 4)
    else:
        fn, args = entry()
        us, xs = fn(*args)
        print("entry OK:", tuple(us.shape), tuple(xs.shape))
