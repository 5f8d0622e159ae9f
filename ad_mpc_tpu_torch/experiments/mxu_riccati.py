"""Tensor cores against one scenario per thread, for batched 7x7 Riccati
algebra on the H100 (port of ``ad_mpc_tpu/experiments/mxu_riccati.py``).

The LQ kernel keeps one scenario per thread and writes the 7x7 stage
algebra out entry by entry on the CUDA cores. This experiment measures
that layout against batched products that may use the tensor cores, on
the same math:

1. **micro**: the Riccati inner op, a chained batched product
   ``X <- A @ X`` (12 links, nx=7) over B=16384 scenarios, in three arms:
   ``bmm_tf32`` (12 chained ``torch.bmm`` with TF32 on, the tensor cores at
   about three decimal digits; not solver-grade, the counterpart of XLA's
   ``"default"`` precision), ``bmm_f32`` (TF32 off, the counterpart of
   ``"highest"``) and ``cuda_lane`` (the lane-layout kernel
   ``csrc/lane_chain.cu``, transposes around it included, as in
   ``lane_chain_build``). The bmm arms are yardsticks, not a port.
2. **macro**: the c2 tick at B=4096 with ``backend="cuda"`` (the
   kernels) against ``backend="plain"`` (their plain PyTorch versions).

Timing (:func:`_time`): ``inner`` = 50 chained, data-dependent
applications with a per-scenario renormalisation between them form one
block, captured once per arm in a CUDA graph, the counterpart of the JAX
micro's jitted ``fori_loop`` (``mxu_riccati.py:83-87``); the number of
replays per round is calibrated to about ``target_s`` of device time; each
round is timed by CUDA events; the minimum over ``rounds`` rounds and the
spread max/min are reported.

    python -m ad_mpc_tpu_torch.experiments.mxu_riccati [--out PATH]
"""

from __future__ import annotations

import argparse
import json
from typing import NamedTuple

import numpy as np
import torch

from ad_mpc_tpu_torch import fleet
from ad_mpc_tpu_torch.experiments import card, require_cuda, tf32, time_replays
from ad_mpc_tpu_torch.ops.cuda_chain import make_lane_chain

H100_FP32_FLOP_PER_S = 67e12  # FP32 outside the tensor cores, H100 SXM data sheet


def _renorm(x):
    """Rescale each scenario (B, nx, nx) to unit max-abs, so the contractive
    chain stays in float32 range over many applications."""
    m = x.abs().amax(dim=(-2, -1), keepdim=True)
    return x / torch.clamp(m, min=1e-30)


INNER = 50  # chained applications per timed block


def _block(fn, a, x, inner=INNER):
    """``inner`` data-dependent applications of ``fn(a, x)``, renormalised."""
    for _ in range(inner):
        x = _renorm(fn(a, x))
    return x


class Timing(NamedTuple):
    s: float  # device seconds per application, min over rounds
    spread: float  # max / min over rounds
    ref: torch.Tensor  # output of the first block of ``inner`` applications from x0
    replays: int  # graph replays made
    captured: int | None  # launches of ``counter`` recorded in the graph


def _time(fn, a, x0, *, inner=INNER, rounds=5, target_s=0.6, counter=None):
    """Device time of one application of ``fn(a, x)``: one block of
    ``inner`` applications captured in a CUDA graph and replayed, chaining
    the blocks as the JAX micro does (``experiments.time_replays``); the
    warm-up block from x0 is the accuracy probe. ``counter`` (the
    lane-chain wrapper) gives the launches recorded at capture."""
    t = time_replays(lambda x: _block(fn, a, x, inner), x0, rounds=rounds,
                     target_s=target_s, counter=counter)
    return Timing(t.s / inner, t.spread, t.ref, t.replays, t.captured)


def bmm_chain(a, x, chain):
    """``chain`` chained ``torch.bmm`` on batch-first (B, nx, nx) tensors."""
    for _ in range(chain):
        x = torch.bmm(a, x)
    return x


def inputs(batch, nx, seed, device):
    """A (contractive, spectral norm about 0.5) and X, as the JAX micro
    draws them (``mxu_riccati.py:115-118``), batch-first float32."""
    rng = np.random.default_rng(seed)
    A = 0.18 * rng.normal(0, 1, (batch, nx, nx)).astype(np.float32)
    X = rng.normal(0, 1, (batch, nx, nx)).astype(np.float32)
    return (torch.as_tensor(A, device=device), torch.as_tensor(X, device=device))


def micro(batch=16384, nx=7, chain=12, seed=0, device="cuda", lane=None):
    """The three arms of the chained product. ``lane`` is the lane-chain
    wrapper to launch (default: a new one). Its ``launches`` grow by the
    warm-up block and the captured block, ``INNER`` each;
    ``cuda_lane_applications`` are those made by graph replay, one kernel
    each: ``cuda_lane_captured_launches`` x ``cuda_lane_replays``.

    ``max_rel_diff_vs_f32`` compares the lane and fp32 arms after the
    first block of ``INNER`` applications, as the JAX micro does. Over 600
    renormalised links two correct float32 products drift apart far beyond
    one application's rounding, so ``*_rel_err_vs_f64`` also give each
    arm's distance from the same block run in float64."""
    device = require_cuda(device)
    A, X = inputs(batch, nx, seed, device)
    flops = 2 * batch * nx**3 * chain
    if lane is None:
        lane = make_lane_chain(nx, chain, device)
    arm = lambda a, x: bmm_chain(a, x, chain)
    with tf32(True):
        tf = _time(arm, A, X)
    with tf32(False):
        f32 = _time(arm, A, X)
        ln = _time(lane, A, X, counter=lane)
    o1, o2 = f32.ref, ln.ref
    scale = float(o1.abs().max()) + 1e-12
    o64 = _block(arm, A.double(), X.double())
    vs64 = lambda o: float((o.double() - o64).abs().max() / o64.abs().max())
    return {
        "device": card(),
        "spread_max_over_min": {"bmm_tf32": tf.spread, "bmm_f32": f32.spread,
                                "lane": ln.spread},
        "batch": batch, "nx": nx, "chain": chain, "flops": flops,
        "bmm_tf32_ms": 1e3 * tf.s,
        "bmm_tf32_gflops": flops / tf.s / 1e9,
        "bmm_f32_ms": 1e3 * f32.s,
        "bmm_f32_gflops": flops / f32.s / 1e9,
        "cuda_lane_ms": 1e3 * ln.s,
        "cuda_lane_gflops": flops / ln.s / 1e9,
        "cuda_lane_pct_fp32_peak": 100 * flops / ln.s / H100_FP32_FLOP_PER_S,
        "cuda_lane_captured_launches": ln.captured,
        "cuda_lane_replays": ln.replays,
        "cuda_lane_applications": INNER * ln.replays,
        "max_rel_diff_vs_f32": float((o1 - o2).abs().max()) / scale,
        "tf32_max_rel_diff_vs_f32": float((o1 - tf.ref).abs().max()) / scale,
        "cuda_lane_rel_err_vs_f64": vs64(o2),
        "bmm_f32_rel_err_vs_f64": vs64(o1),
        "bmm_tf32_rel_err_vs_f64": vs64(tf.ref),
    }


def macro(batch=4096, device="cuda"):
    """The c2 tick through the kernels against their plain versions.
    Each arm reports solves/s, kkt_max and its kernel launches."""
    require_cuda(device)
    out = {}
    for backend in ("cuda", "plain"):
        tick, init, solver, _ = fleet.build_fleet(
            fleet.dynamic_bicycle, fleet.switch_on, device=device,
            backend=backend)
        r, _ = fleet.run_config(tick, init, batch, ticks=10, warmup=5)
        out[backend] = {
            "solves_per_s": r["solves_per_s"], "kkt_max": r["kkt_max"],
            "launches": fleet.launches(solver),
        }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args(argv)
    with tf32(False):
        res = {"device": card(), "micro": micro(), "macro_c2_b4096": macro()}
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)


if __name__ == "__main__":
    main()
