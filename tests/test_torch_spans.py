"""The port's spans (``utils/metrics.py:span``) on the CPU, and the
benchmark's readers of them.

The c2 and c6-fitted ticks run on the plain backend at a small batch under
``torch.profiler`` (CPU activity): each span appears once per tick or
once per Gauss-Newton iteration, inside the span that encloses it, and
the tick's outputs are the same bits with the profiler on and off. The
``launch.*`` spans wrap the kernels' host side, which runs only on the
card (``tests/test_torch_gpu.py::test_tick_spans_on_card``). The readers
of ``benchmark/metrics/`` that read the spans are held to values worked
out by hand on a trace built here.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ad_mpc_tpu_torch import fleet, profile_tick
from ad_mpc_tpu_torch.control.mpc import bicycle_spec
from ad_mpc_tpu_torch.experiments import quad_fleet
from ad_mpc_tpu_torch.ocp.solver import SQPSolver
from ad_mpc_tpu_torch.testing import bike_instance, one_thread  # noqa: F401 (autouse)
from ad_mpc_tpu_torch.utils import metrics
from benchmark import trace
from benchmark.run import Context, metric_reader

ROOT = Path(__file__).resolve().parents[1]
READERS = ["device.idle_in_tick_pct", "glue.host_ms_per_tick", "launch.host_us_p50",
           "tick.syncs_per_tick"]


def _c2():
    tick, init, solver, _ = fleet.build_fleet(
        fleet.dynamic_bicycle, fleet.switch_on, n_nodes=8, device="cpu", backend="plain")
    return tick, init(8, seed=3), 1


def _c6fit():
    tick, init, solver, _ = quad_fleet.build_quad_fleet(
        n_nodes=4, device="cpu", backend="plain", ensemble=quad_fleet.fitted_ensemble())
    return tick, init(4, seed=3), quad_fleet.QUAD_SQP_ITERS


FLEETS = {"c2": _c2, "c6fit": _c6fit}


def _spans(prof):
    """(name, start, end, parent name) of the port's spans, by start; the
    parent is the innermost span that encloses the span. Read from the
    profiler's raw events: the plain GP quad's tick records some 400,000
    operations, which ``prof.events()`` takes half a minute to build."""
    ev = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith(metrics.SPAN_PREFIXES)),
                key=lambda s: (s[1], -s[2]))
    out = []
    for i, (n, a, b) in enumerate(ev):
        outer = [s for j, s in enumerate(ev) if j != i and s[1] <= a and b <= s[2]]
        parent = min(outer, key=lambda s: s[2] - s[1])[0] if outer else None
        out.append((n, a, b, parent))
    return out


def test_span_off_is_one_shared_noop():
    """With no profiler running a span is the one shared no-op context:
    nothing is made and nothing is recorded."""
    assert not torch.autograd._profiler_enabled()
    a, b = metrics.span("fleet.tick"), metrics.span("solver.qp")
    assert a is b
    with a:
        pass


def test_span_is_a_host_event_not_a_user_annotation():
    """On, a span is a host event of the profiler under its own name, not a
    user annotation (which the profiler may copy onto a device's
    timeline)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.span("fleet.tick"):
            with metrics.span("solver.qp"):
                torch.ones(3).add_(1.0)
    ev = {e.name: e for e in prof.events()}
    assert {"fleet.tick", "solver.qp"} <= set(ev)
    for name in ("fleet.tick", "solver.qp"):
        assert not ev[name].is_user_annotation
        assert ev[name].device_type == torch.autograd.DeviceType.CPU
    assert ev["solver.qp"].cpu_parent.name == "fleet.tick"


@pytest.mark.parametrize("config", sorted(FLEETS))
def test_tick_spans_nest(config):
    """Two profiled ticks: every span of the tick once per tick, the
    sweep and the QP once per Gauss-Newton iteration, each inside its
    parent and in order; no kernel launches on the plain backend."""
    tick, carry, iters = FLEETS[config]()
    carry, _ = tick(carry)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            carry, _ = tick(carry)
    spans = _spans(prof)
    children = {}
    for n, _, _, parent in spans:
        children.setdefault(parent, []).append(n)
    assert children[None] == ["fleet.tick"] * 2
    assert children["fleet.tick"] == ["fleet.reference", "solver.solve", "fleet.plant",
                                      "solver.shift"] * 2
    assert children["solver.solve"] == (["solver.sweep", "solver.qp"] * iters
                                        + ["solver.defect"]) * 2
    assert set(children) == {None, "fleet.tick", "solver.solve"}
    assert not [s for s in spans if s[0].startswith("launch.")]


def test_single_vehicle_solve_spans():
    """The single vehicle's solve (``SQPSolver``, two Gauss-Newton
    iterations) records the solver's spans as the fleet's solve does, and
    its shift one span."""
    spec = bicycle_spec(t_horizon=0.4, n_nodes=8, sqp_iters=2)
    solver = SQPSolver(spec, fleet.dynamic_bicycle, p_dim=1, device="cpu")
    x0, yref_x, yref_u, p = (
        torch.as_tensor(a, dtype=torch.float32)
        for a in bike_instance(np.random.default_rng(4), 8, spec.dt, switch=1.0))
    state = solver.init_state(x0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solver.shift(solver.solve(x0, yref_x, yref_u, p, state).state)
    spans = _spans(prof)
    assert [(n, parent) for n, _, _, parent in spans] == [
        ("solver.solve", None),
        ("solver.sweep", "solver.solve"), ("solver.qp", "solver.solve"),
        ("solver.sweep", "solver.solve"), ("solver.qp", "solver.solve"),
        ("solver.defect", "solver.solve"), ("solver.shift", None)]


def _flat(out):
    """Every tensor of a tick's (carry, aux), in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


@pytest.mark.parametrize("config", sorted(FLEETS))
def test_tick_bits_with_profiler_on_and_off(config):
    """The same carry ticked with the profiler off and on gives the same
    bits in every output."""
    tick, carry, _ = FLEETS[config]()
    carry, _ = tick(carry)
    off = _flat(tick(carry))
    with profile(activities=[ProfilerActivity.CPU]):
        on = _flat(tick(carry))
    assert len(off) == len(on) > 0
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_profile_tick_sums_the_spans():
    """``profile_tick.span_ms`` gives each span's host time and calls per
    tick from the profiler's averages, and leaves out every other event."""
    avg = [SimpleNamespace(key=k, cpu_time_total=us, count=n) for k, us, n in (
        ("fleet.tick", 9000.0, 2), ("solver.sweep", 1200.0, 4), ("launch.vde", 80.0, 4),
        ("aten::cat", 700.0, 8), ("cudaLaunchKernel", 90.0, 40))]
    rows = profile_tick.span_ms(avg, 2)
    assert rows == {"fleet.tick": (4.5, 1.0), "solver.sweep": (0.6, 2.0),
                    "launch.vde": (0.04, 2.0)}


# ------------------------------------------------------------ the readers


def _trace(spans=True):
    """Two ticks on a 1,500 us wall: device operations, the CUDA runtime's
    host calls and, with ``spans``, the port's spans."""
    ops = [trace.DeviceOp("void vde_kernel<BicycleDyn>()", 100.0, 300.0, True),
           trace.DeviceOp("void lq_ipm_kernel<7, 2>()", 500.0, 900.0, True),
           trace.DeviceOp("Memcpy DtoH (Device -> Pinned)", 1000.0, 1100.0, False),
           trace.DeviceOp("void rk4_kernel<BicycleDyn>()", 1310.0, 1400.0, True)]
    host = [("cudaLaunchKernel", 60.0, 70.0),
            ("cudaStreamSynchronize", 1000.0, 1200.0),  # the client's fetch
            ("cudaStreamSynchronize", 1250.0, 1260.0),
            ("cudaMemcpyAsync", 1270.0, 1280.0),
            ("cudaMemcpy", 1280.0, 1290.0)]
    if spans:
        host += [("fleet.tick", 0.0, 1000.0), ("launch.vde", 50.0, 80.0),
                 ("solver.qp", 350.0, 460.0), ("launch.lq_ipm", 400.0, 450.0),
                 ("fleet.tick", 1200.0, 1500.0), ("launch.rk4", 1210.0, 1240.0)]
    return trace.Trace(ops, host, ticks=2, wall_s=0.0015)


def _read(name, tr):
    cfg = json.loads((ROOT / "benchmark" / "configs" / "c2.json").read_text())
    return metric_reader(name)(Context(tr, cfg, 16384, [1.0]))


@pytest.mark.parametrize("name,want", [
    # idle inside the ticks: 1000 - 600 busy, 300 - 90 busy, over 1500 us
    ("device.idle_in_tick_pct", 100.0 * 610.0 / 1500.0),
    # (1000 - 30 - 50) + (300 - 30) us over two ticks
    ("glue.host_ms_per_tick", 1190.0 / 1e3 / 2),
    ("launch.host_us_p50", 30.0),
    # the sync at 1250 and the blocking copy at 1280; the fetch starts at
    # the first tick's end, and the asynchronous copy does not wait
    ("tick.syncs_per_tick", 2 / 2),
])
def test_span_readers(name, want):
    assert _read(name, _trace()) == pytest.approx(want)


def test_idle_in_tick_is_part_of_idle():
    """The idle share inside the ticks and the one between them (100 us of
    the fetch) make up ``device.idle_pct``; no gap inside a tick is left
    unnamed."""
    tr = _trace()
    between = 100.0 * 100.0 / 1500.0
    assert _read("device.idle_pct", tr) == pytest.approx(
        _read("device.idle_in_tick_pct", tr) + between)
    gaps = {round(s * 1e6): n for n, s in trace.idle_gaps(tr)}
    assert gaps == {210: "fleet.tick", 200: "launch.lq_ipm", 100: "fleet.tick"}


@pytest.mark.parametrize("name", READERS)
def test_span_readers_find_nothing_without_spans(name):
    """A trace of a program without the spans, and an empty one: nothing
    to read, never 0."""
    assert _read(name, _trace(spans=False)) is None
    assert _read(name, trace.Trace([], [], 0, 0.0)) is None


def test_span_readers_in_the_benchmark():
    """Each reader is a per-layer metric read from the device trace; none
    is read without a trace."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["source"] == "device_trace" and m["moves"] == "tick_ms_p95"
        assert "enqueue" not in name
