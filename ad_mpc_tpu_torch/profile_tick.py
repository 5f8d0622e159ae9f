"""Where the time of a fleet tick goes, on the card.

    python -m ad_mpc_tpu_torch.profile_tick [--config c2|c3|c4|c5|c6|ad]
                                            [--batch 1024 16384] [--ticks 10]
                                            [--out PATH]

``--config``: the c2 bicycle tick (``fleet.build_fleet``), the c3
GP-bicycle tick (``fleet.make_gp_bicycle``), the c4 Pacejka tick
(``fleet.make_pacejka``, speeds capped), the c5 quad tick
(``experiments.quad_fleet.build_quad_fleet``, two Gauss-Newton
iterations), the c6 GP-quad tick (the same with the bench's synthetic
32-point ensemble, ``quad_fleet.make_quad_gp_ensemble``) or ``ad``, the
single vehicle's controller tick at N=40 (B=1 only): the deployment
node's fused step (``BicycleMPC.make_fused_step``: the RTI solve, shift,
gates and command) and its one fetch of the 4-float result. For each
batch size: 5 warm-up ticks, then ``--ticks`` ticks under ``torch.profiler``
(CPU and CUDA activities). Prints the device time per tick of each kernel
(the port's three kernels and PyTorch's own), the tick's wall time after a
``synchronize``, the device's busy share of that window: summed kernel
time over wall time (one stream, so kernels do not overlap), and the host
time per tick of each of the port's spans (``utils.metrics.span``: the
fleet's tick, the solver's phases, the kernel wrappers' host side).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ad_mpc_tpu_torch import fleet
from ad_mpc_tpu_torch.experiments import quad_fleet
from ad_mpc_tpu_torch.utils.metrics import SPAN_PREFIXES


def device_us(evt):
    """Device microseconds of a ``torch.profiler`` key average."""
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def _c4():
    dyn, p_of, v_cap = fleet.make_pacejka()
    return fleet.build_fleet(dyn, p_of, v_cap=v_cap, device="cuda")


def _ad():
    """The AD controller's tick as a fleet of one: the fused step on a fixed
    state and reference window (``testing.bike_instance``), then the fetch
    of its output."""
    import numpy as np

    from ad_mpc_tpu_torch.control.mpc import BicycleMPC, bicycle_spec
    from ad_mpc_tpu_torch.testing import bike_instance

    spec = bicycle_spec()
    mpc = BicycleMPC(spec=spec, device="cuda")
    step = mpc.make_fused_step()
    x0, yref, _, _ = (torch.as_tensor(a, dtype=torch.float32, device="cuda")
                      for a in bike_instance(np.random.default_rng(22), 40, spec.dt))
    packed = torch.cat([x0[None], yref]).contiguous()

    def init(batch):
        if batch != 1:
            raise ValueError("the AD tick runs one vehicle: --batch 1")
        return mpc.fused_init(x0)

    def tick(carry):
        out, *carry = step(packed, *carry)
        return tuple(carry), out.cpu()

    return tick, init, mpc.solver, spec


FLEETS = {
    "c2": lambda: fleet.build_fleet(fleet.dynamic_bicycle, fleet.switch_on,
                                    device="cuda"),
    "c3": lambda: fleet.build_fleet(fleet.make_gp_bicycle(), fleet.switch_on,
                                    device="cuda"),
    "c4": _c4,
    "c5": lambda: quad_fleet.build_quad_fleet(device="cuda"),
    "c6": lambda: quad_fleet.build_quad_fleet(
        device="cuda", ensemble=quad_fleet.make_quad_gp_ensemble()),
    "ad": _ad,
}


def span_ms(averages, ticks):
    """{span: (host ms per tick, calls per tick)} of the port's spans in a
    profiler's ``key_averages()`` over ``ticks`` ticks."""
    return {evt.key: (evt.cpu_time_total / 1e3 / ticks, evt.count / ticks)
            for evt in averages if evt.key.startswith(SPAN_PREFIXES)}


def profile_batch(batch, ticks, config="c2"):
    tick, init, _, _ = FLEETS[config]()
    carry = init(batch)
    for _ in range(5):
        carry, _ = tick(carry)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        for _ in range(ticks):
            carry, _ = tick(carry)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - tic) / ticks
    kernels = {}
    averages = prof.key_averages()
    for evt in averages:
        us = device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = (us / 1e3 / ticks, evt.count // ticks)
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "config": config, "batch": batch, "ticks": ticks, "tick_wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "kernels_launched_per_tick": sum(n for _, n in kernels.values()),
        "kernels": [{"name": k[:80], "ms_per_tick": ms, "launches_per_tick": n}
                    for k, (ms, n) in top],
        "spans": [{"name": k, "host_ms_per_tick": ms, "calls_per_tick": n}
                  for k, (ms, n) in sorted(span_ms(averages, ticks).items())],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(FLEETS), default="c2")
    ap.add_argument("--batch", type=int, nargs="+",
                    help="batch sizes (default 1024 16384; 1 for ad)")
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--out", help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_tick: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    batches = args.batch or ([1] if args.config == "ad" else [1024, 16384])
    rows = [profile_batch(b, args.ticks, args.config) for b in batches]
    for r in rows:
        print(f"{r['config']} B={r['batch']}: tick {r['tick_wall_ms']:.3f} ms wall, device "
              f"busy {r['device_busy_ms']:.3f} ms ({100 * r['device_busy_share']:.1f}%)"
              f", {r['kernels_launched_per_tick']} kernels per tick on "
              f"{torch.cuda.get_device_name(0)}")
        for k in r["kernels"][:8]:
            print(f"  {k['ms_per_tick']:9.4f} ms  x{k['launches_per_tick']:<3d} {k['name']}")
        print("  host time per tick by span:")
        for k in r["spans"]:
            print(f"  {k['host_ms_per_tick']:9.4f} ms  x{k['calls_per_tick']:<3g} {k['name']}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)


if __name__ == "__main__":
    main()
