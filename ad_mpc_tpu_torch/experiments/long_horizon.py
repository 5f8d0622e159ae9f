"""Long-horizon Riccati backends on the H100: the sequential recursion
against the associative scan (port of
``ad_mpc_tpu/experiments/long_horizon.py``).

Batch-1 float32 LQ solves at the bicycle's stage sizes (nx=7, nu=2) over
horizons N, sequential :func:`ad_mpc_tpu_torch.ops.riccati.lqr_solve`
against :func:`ad_mpc_tpu_torch.ops.assoc_riccati.lqr_solve_assoc`, with
TF32 off (the counterpart of the JAX micro's
``default_matmul_precision("highest")``). Reports per-N device times, the
first N where the scan wins (or None), and the agreement of the two on
the card. Both backends are eager PyTorch, a chain of small launches at
batch 1: a block of 30 chained solves is captured once per backend in a
CUDA graph and the replays are timed (``experiments.time_replays``), the
counterpart of the JAX micro's jitted block, so the host's launch rate
drops out and the times are the device's. cuSOLVER serves the linear
algebra (:func:`cusolver`): MAGMA's batched Cholesky solve cannot be
captured.

    python -m ad_mpc_tpu_torch.experiments.long_horizon [--out PATH]
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from ad_mpc_tpu_torch.experiments import card, require_cuda, tf32, time_replays
from ad_mpc_tpu_torch.ops.assoc_riccati import lqr_solve_assoc
from ad_mpc_tpu_torch.ops.riccati import lqr_solve


def random_lq(rng, N, nx=7, nu=2, dtype=torch.float32, device="cuda"):
    """A well-conditioned random LQ instance (contractive A, SPD blocks),
    drawn as the JAX experiment draws it, with a batch axis of 1."""
    A = 0.95 * np.stack([np.eye(nx) + 0.05 * rng.normal(0, 1, (nx, nx))
                         for _ in range(N)])
    B = 0.1 * rng.normal(0, 1, (N, nx, nu))
    c = 0.01 * rng.normal(0, 1, (N, nx))
    Q = np.stack([np.eye(nx)] * (N + 1)) * rng.uniform(0.5, 2.0)
    q = 0.1 * rng.normal(0, 1, (N + 1, nx))
    R = np.stack([np.eye(nu)] * N)
    r = 0.1 * rng.normal(0, 1, (N, nu))
    dx0 = rng.normal(0, 1, nx)
    return tuple(torch.as_tensor(v[None], dtype=dtype, device=device)
                 for v in (A, B, c, Q, q, R, r, dx0))


@contextlib.contextmanager
def cusolver():
    """cuSOLVER as PyTorch's CUDA linear-algebra backend inside the block
    (capturable in a CUDA graph), restored after."""
    old = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(old)


def solve_block(solve_fn, ops, inner=30):
    """``inner`` chained solves: solve k perturbs dx0 by a bounded function
    of solve k-1's terminal state, so no two overlap. Returns
    block(carry (1, nx)) -> carry."""
    A, B, c, Q, q, R, r, dx0 = ops

    def block(cy):
        for _ in range(inner):
            dxs, _dus = solve_fn(A, B, c, Q, q, R, r, dx0 + 1e-6 * torch.tanh(cy))
            cy = dxs[:, -1]
        return cy

    return block


def _time_solver(solve_fn, ops, *, inner=30, rounds=5, target_s=0.4):
    """Device time of one solve by graph replay of :func:`solve_block`.
    Returns (seconds per solve [min over rounds], spread max/min)."""
    t = time_replays(solve_block(solve_fn, ops, inner), ops[-1],
                     rounds=rounds, target_s=target_s)
    return t.s / inner, t.spread


def micro(horizons=(30, 128, 512), nx=7, nu=2, seed=0, device="cuda"):
    """Both backends at each horizon, float32, TF32 off."""
    device = require_cuda(device)
    rng = np.random.default_rng(seed)
    rows, crossover = {}, None
    with tf32(False), cusolver():
        for N in horizons:
            ops = random_lq(rng, N, nx, nu, device=device)
            _, dus_s = lqr_solve(*ops)
            _, dus_a = lqr_solve_assoc(*ops)
            scale = float(dus_s.abs().max()) + 1e-12
            err = float((dus_s - dus_a).abs().max()) / scale
            t_seq, sp_seq = _time_solver(lqr_solve, ops)
            t_assoc, sp_assoc = _time_solver(lqr_solve_assoc, ops)
            rows[f"N{N}"] = {
                "seq_ms": 1e3 * t_seq,
                "assoc_ms": 1e3 * t_assoc,
                "assoc_over_seq": t_assoc / t_seq,
                "spread": {"seq": sp_seq, "assoc": sp_assoc},
                "max_rel_diff": err,
            }
            if crossover is None and t_assoc < t_seq:
                crossover = N
    return {
        "device": card(), "nx": nx, "nu": nu, "batch": 1, "dtype": "float32",
        "rows": rows,
        # The first measured horizon where the scan wins; None: it lost at
        # every measured N on this device.
        "crossover_n": crossover,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args(argv)
    text = json.dumps(micro(), indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)


if __name__ == "__main__":
    main()
