"""The fleet stepper over ranks (the counterpart of
``ad_mpc_tpu/parallel/batch.py``).

:class:`BatchedSolver` is a thin stepper over the port's
:class:`~ad_mpc_tpu_torch.ocp.solver.BatchedSQPSolver` and owns no solver
logic: ``step`` is one solve of every scenario plus the RTI shift, and
``init_states`` the cold start by a constant-input rollout. With a process
group each rank steps its own block of the global batch
(:func:`~ad_mpc_tpu_torch.parallel.mesh.shard_slice`) with no per-solve
collective; only diagnostics reductions (:meth:`BatchedSolver.kkt_mean`)
cross ranks.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ad_mpc_tpu_torch.ocp.solver import BatchedSQPSolver, SolverState
from ad_mpc_tpu_torch.ocp.spec import OCPSpec
from ad_mpc_tpu_torch.parallel.mesh import RankLayout, make_layout, shard_slice


class BatchedSolver:
    """Fleet-of-scenarios MPC: every argument has a leading batch dim.

    :param group: ``None`` (the batch stays in this process) or a process
        group of ``torch.distributed`` (``dist.group.WORLD`` for the default
        one): the arrays a rank passes are its block of the global batch
        (:meth:`local`).
    :param layout: the ranks' layout (1-D over the group by default).

    The diagnostics reductions run where the group's backend reduces: on
    the CPU under ``gloo``, on the rank's device otherwise
    (``reduce_device``).
    """

    def __init__(self, spec: OCPSpec, dynamics: Callable, p_dim: int = 0,
                 device="cuda", backend: str = "auto", group=None,
                 layout: Optional[RankLayout] = None):
        self.spec = spec
        self.p_dim = p_dim
        self.solver = BatchedSQPSolver(spec, dynamics, p_dim=p_dim,
                                       device=device, backend=backend)
        self.backend = self.solver.backend
        self.device = torch.device(device)
        self.group = group
        if group is not None:
            self.rank, world = dist.get_rank(group), dist.get_world_size(group)
        else:
            self.rank, world = 0, 1
        self.layout = layout if layout is not None else make_layout(world)
        if self.layout.world != world:
            raise ValueError(f"layout of {self.layout.world} ranks, group of {world}")
        self.reduce_device = (torch.device("cpu") if group is not None
                              and dist.get_backend(group) == "gloo" else self.device)

    def local(self, a):
        """This rank's block of a global batch ``a`` (B, ...)."""
        return a[shard_slice(a.shape[0], self.rank, self.layout)]

    def step(self, x0s, yref_xs, yref_us, params, states: SolverState):
        """One fleet control tick: solve every scenario, shift every warm
        start. Returns (us, xs, next_states, kkt)."""
        res = self.solver.solve(x0s, yref_xs, yref_us, params, states)
        return res.us, res.xs, self.solver.shift(res.state), res.kkt_residual

    @torch.no_grad()
    def init_states(self, x0s, u0=None) -> SolverState:
        """Cold-start warm starts by the rollout of a constant input (zero
        by default) with p = 0: N launches of the RK4 map on the card."""
        spec, solver = self.spec, self.solver
        x = torch.as_tensor(x0s, dtype=torch.float32, device=solver.Q.device)
        B = x.shape[0]
        u = (x.new_zeros((B, spec.nu)) if u0 is None
             else torch.as_tensor(u0, dtype=torch.float32, device=x.device))
        p = x.new_zeros((B, self.p_dim))
        xs = [x]
        for _ in range(spec.n_nodes):
            x = solver.F(x, u, p)
            xs.append(x)
        us = u[:, None].expand(-1, spec.n_nodes, -1).contiguous()
        return SolverState(xs=torch.stack(xs, dim=1), us=us)

    def kkt_mean(self, kkt) -> float:
        """The mean KKT defect over the global batch: the group's one
        reduction (a sum and a count), or the local mean without a group."""
        if self.group is None:
            return float(kkt.mean())
        t = torch.stack([kkt.double().sum(), torch.tensor(
            float(kkt.numel()), dtype=torch.float64, device=kkt.device)])
        t = t.to(self.reduce_device)
        dist.all_reduce(t, group=self.group)
        return float(t[0] / t[1])
