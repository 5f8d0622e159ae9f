"""Run one cell of the port's benchmark once, on the card.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``. The cell names
its configuration (``benchmark/configs/<config>.json``: the port's entry,
the model, the OCP, the frozen counts) and its traffic
(``benchmark/traffic/<traffic>.json``: the batch, the warm-up, the scenario
draw, the check's sample, the profiled block); the limit of each number
compared is in ``benchmark/limits/<workload>.json`` and each per-layer
metric's reader in ``benchmark/metrics/<metric>.py``.

A run builds the fleet through the port's entry, draws it from the seed,
warms it up, then calls its ``tick(carry)`` back to back for ``--seconds``:
each tick ends when the next states and the KKT residuals are in pinned
host buffers, as a fleet controller that publishes every tick needs them.
With ``--trace 1`` the same loop profiles a fixed block of ticks inside the
window. Then the program's state is freed and the plain reference judges
the ticks it recorded (``benchmark/check.py``). The last line of standard
output is the result; the numbers compared, each with its limit, are the
last lines of standard error and the result's last key.
"""

from __future__ import annotations

import os
import time

_T0 = time.time()  # noqa: E402, set before the heavy imports

import argparse
import importlib.util
import json
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np

from benchmark import traffic as gen

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ad_mpc_tpu")
# The configurations state their KKT gates after the warm-up and this many
# ticks (the JAX bench's window).
GATE_TICK = 20


def process_start() -> float:
    """The wall-clock time this process started (Linux ``/proc``), or the
    time this module was first read where that cannot be told."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Cell(NamedTuple):
    name: str
    cfg: dict
    traffic: dict
    limits: dict
    per_layer: list  # the BENCHMARK.json entries of the per-layer metrics
    chips: int


def load_cell(workload: str, bench_file: Path | None = None) -> Cell:
    """The cell of ``workload`` with its configuration, traffic, limits and
    per-layer metrics, each found by name."""
    bench_file = bench_file or ROOT.parent / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench_file.name}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((bench_file.parent / conf["file"]).read_text())
    traffic = gen.load(w["traffic"])
    limits = json.loads((ROOT / "limits" / f"{workload}.json").read_text())
    return Cell(workload, cfg, traffic, limits, bench["per_layer"], int(w["chips"]))


def metric_reader(name: str):
    """``read(ctx)`` of ``benchmark/metrics/<name>.py``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context(NamedTuple):
    """What a per-layer metric's reader reads."""

    trace: object  # benchmark.trace.Trace of the profiled block
    cfg: dict
    batch: int
    enqueue_ms: list  # host ms for tick(carry) to return, outside the block


def run(cell: Cell, seed: int, seconds: float, trace_on: bool, device="cuda",
        backend="auto", fleet=None, t_start: float | None = None) -> dict:
    """One run of ``cell``: the result's object, without its device
    group. ``fleet`` replaces the port's fleet (the control, or a fault in
    a test); ``device``/``backend`` let the CPU tests drive a run."""
    import torch

    from benchmark import check, fleets

    t_start = process_start() if t_start is None else t_start
    phases = {"imports": time.time() - t_start}
    on_card = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec, cfg = cell.traffic, cell.cfg
    B = int(spec["batch"])
    draw = gen.draw(spec, cfg["family"], seed)
    rows, fractions = gen.sample(spec, seed)
    fleet = fleet or fleets.PortFleet(cfg, device=device, backend=backend)
    phases["build"] = time.time() - t_start - sum(phases.values())
    carry = fleet.init(draw, B, gen.seed_of(seed))
    phases["init"] = time.time() - t_start - sum(phases.values())
    rec = check.Recorder(fleet.view, int(spec["check"]["start_ticks"]), rows)
    fetch = [k for k in spec["fetch"] if k != "kkt"]
    host = None

    def publish(carry, kkt):
        """The tick's outputs into the host buffers, waited on."""
        nonlocal host
        v = fleet.view(carry)
        outs = [v[k] for k in fetch] + [kkt]
        if host is None:
            host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=on_card) for o in outs]
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
        if on_card:
            torch.cuda.current_stream().synchronize()
        return host[-1]

    kkt_ticks = []  # (mean, max) of every tick's KKT residuals, from the host copy
    for _ in range(int(spec["warmup_ticks"])):
        carry, kkt = fleet.tick(carry)
        kh = publish(carry, kkt)
        kkt_ticks.append((float(kh.mean()), float(kh.max())))
        rec.after_start_tick(carry, kkt)
    rec.before_window_tick(carry)  # every path of the window runs once before it
    phases["warmup"] = time.time() - t_start - sum(phases.values())
    prof_cfg = spec["profile"]
    if trace_on and on_card:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            carry, kkt = fleet.tick(carry)
            publish(carry, kkt)
    setup_s = time.time() - t_start
    phases["profiler"] = setup_s - sum(phases.values())

    tick_s, enqueue_s, failed = [], [], 0
    prof, prof_wall, prof_ticks = None, 0.0, 0
    launches0 = fleet.launches()
    next_rec = 0
    t0 = time.perf_counter()
    t_end = t0
    n = 0
    while t_end - t0 < seconds:
        in_block = trace_on and int(prof_cfg["after_ticks"]) <= n < (
            int(prof_cfg["after_ticks"]) + int(prof_cfg["ticks"]))
        # A recording's copies stay out of the profiled block: one due in
        # it is taken at the first tick after it.
        recording = (next_rec < len(fractions) and not in_block
                     and time.perf_counter() - t0 >= fractions[next_rec] * seconds)
        if recording:
            rec.before_window_tick(carry)
        if in_block and prof is None:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            block_t0 = time.perf_counter()
        a = time.perf_counter()
        carry, kkt = fleet.tick(carry)
        b = time.perf_counter()
        kh = publish(carry, kkt)
        t_end = time.perf_counter()
        tick_s.append(t_end - a)
        if not in_block:
            enqueue_s.append(b - a)
        else:
            prof_ticks += 1
            if prof_ticks == int(prof_cfg["ticks"]):
                prof_wall = time.perf_counter() - block_t0
                prof.__exit__(None, None, None)
        if not np.isfinite(kh.numpy().sum()):
            failed += int((~np.isfinite(kh.numpy())).sum())
        if n == GATE_TICK - 1:  # the point at which the configuration states its gates
            gate_tick = (float(kh.mean()), float(kh.max()))
        if recording:
            rec.after_window_tick(carry, kkt)
            next_rec += 1
        n += 1
    window_s = t_end - t0
    launches = {k: v - launches0.get(k, 0) for k, v in fleet.launches().items()}
    if n < GATE_TICK:
        gate_tick = kkt_ticks[-1]
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    del carry, kkt, fleet
    if on_card:
        torch.cuda.empty_cache()

    t_judge = time.time()
    verdict = check.judge(cfg, draw, rec, device)
    phases["judge"] = time.time() - t_judge
    limits = cell.limits
    checks = {
        "gap_ratio": {"value": verdict["gap_ratio"], "limit": limits["gap_ratio"]},
        "kkt_mean_at_gate_tick": {"value": gate_tick[0], "limit": cfg["gates"]["kkt_mean"]},
        "kkt_max_at_gate_tick": {"value": gate_tick[1], "limit": cfg["gates"]["kkt_max"]},
    }
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    out = {
        "correct": bool(correct),
        "attempted": B * n,
        "failed": failed,
        "ticks": n,
        "window_s": window_s,
        "setup_s": setup_s,
        "launches_per_tick": {k: v / n for k, v in launches.items()} if n else {},
        "checked_rows": verdict["rows"],
        "worst_output": verdict["worst_output"],
        "ratios": verdict["ratios"],
        "phases": phases,
        "tick_ms_quartiles": {
            half: [1e3 * float(q) for q in np.percentile(part, [25, 50, 75, 95])]
            for half, part in (("first_half", tick_s[: n // 2]), ("second_half", tick_s[n // 2:]))
            if len(part)},
        "checks": checks,
    }
    if trace_on:
        from benchmark import trace

        tr = (trace.reduce(prof, prof_ticks, prof_wall) if prof is not None
              and prof_ticks == int(prof_cfg["ticks"]) else None)
        ctx = Context(tr, cfg, B, [1e3 * s for s in enqueue_s])
        out["per_layer"] = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx) if tr is not None or "enqueue" in m["name"] else None
            if v is not None:
                out["per_layer"][m["name"]] = {"value": float(v), "unit": m["unit"]}
        if tr is not None:
            out["busy_s"] = trace.busy_s(tr)
            out["traced_window_s"] = tr.wall_s
            out["breakdown"] = {"device_ops": trace.device_ops(tr),
                                "idle_gaps": trace.idle_gaps(tr)}
    else:
        out["end_to_end"] = {
            "solves_per_s": {"value": B * n / window_s, "unit": "solves/s"},
            "tick_ms_p95": {"value": 1e3 * float(np.percentile(tick_s, 95)), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    out["memory_peak_bytes"] = int(memory_peak)
    return out


def result_line(out: dict, device_info: dict, trace_on: bool) -> dict:
    """The contract's last line: correct, attempted, failed, the cell's
    metrics, the device, the breakdown, and the numbers compared last."""
    line = {
        "correct": out["correct"],
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": out["per_layer"] if trace_on else out["end_to_end"],
        "device": dict(device_info, memory_peak_bytes=out["memory_peak_bytes"]),
    }
    if trace_on and "busy_s" in out:
        line["device"]["busy_s"] = out["busy_s"]
        line["device"]["window_s"] = out["traced_window_s"]
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    import torch

    cell = load_cell(args.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = run(cell, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    line = result_line(out, info, bool(args.trace))
    print(f"benchmark: {args.workload} seed {args.seed}: {out['ticks']} ticks in "
          f"{out['window_s']:.3f} s, set-up {out['setup_s']:.3f} s, launches per tick "
          f"{out['launches_per_tick']} (the configuration states "
          f"{cell.cfg['port'].get('launches_per_tick')}), {out['checked_rows']} rows "
          f"checked, worst output {out['worst_output']!r}", file=sys.stderr)
    print(f"benchmark: seconds by phase {json.dumps(out['phases'])}; tick ms quartiles "
          f"and p95 {json.dumps(out['tick_ms_quartiles'])}; worst ratio by output "
          f"{json.dumps(out['ratios'])}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
