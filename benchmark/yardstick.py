"""The kernels' least times on an H100, from counts frozen in the
configuration files.

A configuration's ``counts`` group holds, per kernel, the operations of
one unit of work (a stage of the sweep, a stage of one IPM iteration)
written down once as numbers with their derivation. This module turns
them into a launch's operations and bytes at a batch and horizon, and
those into the least time: the larger of bytes over the memory rate and
operations over the FP32 rate. Nothing here calls the system under test,
so the count stays the same work whatever implements the kernel.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and FP32 rate outside the
# tensor cores (dense), at the card's full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

# One RK4 step's combination per state entry, as the sweep does it: three
# stage points x + h k and two accumulations acc + 2 k (multiply-adds, two
# operations each), then x + h/6 (acc + k).
RK4_COMBINE = 3 * 2 + 2 * 2 + 3


def vde_flops_per_stage(vde: dict, nx: int, nu: int) -> int:
    """Operations of one stage of the sensitivity sweep: 4 evaluations of
    the dynamics, each its primal once and its tangent cost per tangent
    (nx + nu of them), the RK4 combination for the primal and each tangent,
    the defect (nx), and ``extra_per_evaluation`` per evaluation (a GP
    residual's means, gradients and lift)."""
    nt = nx + nu
    base = 4 * (vde["dyn_primal"] + nt * vde["dyn_tangent"])
    return (base + nx * RK4_COMBINE * (1 + nt) + nx
            + 4 * vde.get("extra_per_evaluation", 0))


def gp_quad_extra_per_evaluation(g: dict) -> int:
    """Operations a body-frame GP residual adds to one evaluation of the
    quad's sweep: the rotations, the means of D outputs over n points of d
    features in the form that keeps X sqrt(0.5)/l in the table (less the
    D adds into a row, which the rotation replaces), their closed-form
    gradients, the residual's Jacobian in (q, v), and its lift onto the
    nx + nu tangents by one contraction of 7 entries per tangent and
    output."""
    n, D, d = g["points"], g["outputs"], g["features"]
    primal = D * d + n * D * (3 * d + 2) + D
    grad = n * D * 2 * d + D * d
    lift = D * (g["nx"] + g["nu"]) * 2 * g["lift_entries"]
    return g["rotations"] + primal - D + grad + g["jacobian"] + lift


def vde_bytes(B: int, N: int, nx: int, nu: int, p_dim: int) -> int:
    """Bytes of one sweep: xs, us, p read once; A, Bm, c written once."""
    return 4 * (B * (N + 1) * nx + B * N * nu + B * p_dim
                + B * N * (nx * nx + nx * nu + nx))


def lq_flops_per_stage_iter(nx: int, nu: int) -> int:
    """Operations of one stage of one IPM iteration: the Riccati step's
    cubic terms plus 16 per variable for the cone eliminations."""
    return 3 * nx ** 3 + 4 * nx ** 2 * nu + 2 * nx * nu ** 2 + nu ** 3 + 16 * (nx + nu)


def lq_bytes(B: int, N: int, nx: int, nu: int) -> int:
    """Bytes of one QP: A, Bm, c, q, r, u_ref, x_ref read once; dx, du and
    the step size written once."""
    reads = (N * nx * nx + N * nx * nu + N * nx + (N + 1) * nx + N * nu + N * nu
             + (N + 1) * nx)
    writes = (N + 1) * nx + N * nu + 1
    return 4 * B * (reads + writes)


def bound_ms(n_bytes: float, n_flops: float) -> tuple:
    """(least ms, "bytes" or "operations": which of the two binds)."""
    t_mem, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FP32_FLOP_PER_S
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


def kernel_bounds(cfg: dict, batch: int) -> dict:
    """{"vde": (ms, binds, bytes, flops), "lq_ipm": ...} of one launch of
    each kernel of a configuration at ``batch`` rows."""
    ocp, counts = cfg["ocp"], cfg["counts"]
    N, nx, nu = int(ocp["n_nodes"]), int(ocp["nx"]), int(ocp["nu"])
    p_dim = int(cfg["model"].get("p_dim", 0))
    vde_b = vde_bytes(batch, N, nx, nu, p_dim)
    vde_f = batch * N * counts["vde"]["flops_per_stage"]
    lq_b = lq_bytes(batch, N, nx, nu)
    lq_f = batch * N * int(ocp["qp_iters"]) * counts["lq_ipm"]["flops_per_stage_iter"]
    return {"vde": (*bound_ms(vde_b, vde_f), vde_b, vde_f),
            "lq_ipm": (*bound_ms(lq_b, lq_f), lq_b, lq_f)}
