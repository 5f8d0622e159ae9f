"""CPU tests of the port's benchmark, and one card test.

    python -m pytest benchmark/ -q            # here: the card test skips
    python -m pytest benchmark/ -q -m gpu     # on a machine with the card

A run is driven on the CPU with the port's plain backend at a small batch
(``_small``): the harness, the recorder and the judge are the ones the
card runs; only the look for a card is skipped.
"""

from __future__ import annotations

import ast
import copy
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, fleets, trace, traffic, yardstick
from benchmark.reference import ocp
from benchmark.run import Context, forbidden_modules, load_cell, metric_reader, run

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 12345  # a seed past the signed 32-bit range
# A cell of each reference family.
BICYCLE, QUAD = (next(w for w in WORKLOADS if load_cell(w).cfg["family"] == f)
                 for f in ("bicycle_arcs", "quad_circles"))


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _small(workload, batch=8, warmup=None):
    """The cell with a small batch, every row checked and a short profile."""
    cell = load_cell(workload)
    t = copy.deepcopy(cell.traffic)
    t["batch"] = batch
    t["check"]["rows"] = batch
    if warmup is not None:
        t["warmup_ticks"] = warmup
    return cell._replace(traffic=t)


def _run(cell, fleet=None, seconds=1.5):
    return run(cell, SEED, seconds, False, device="cpu", backend="plain", fleet=fleet,
               t_start=time.time())


# ------------------------------------------------------------ the reference


# The states' and controls' agreement of two float32 runs of one algorithm
# over three ticks: the bicycle's to float32 rounding; the fitted GP
# quadrotor's solve moves by about 1e-4 under a rounding of its GP means
# (another order of summation), which its 18 interior-point iterations at
# the input box carry on.
AGREE = {"bicycle_arcs": 2e-5, "quad_circles": 5e-4}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_agrees_with_plain_port(workload):
    """Three ticks of the reference from the traffic's draw, following its
    own state, against the port's plain fleet on the same draw: in float32
    the same algorithm gives the same numbers to float32's rounding, and
    the float64 reference lies within float32's reach of both."""
    cell = _small(workload, batch=6)
    agree = AGREE[cell.cfg["family"]]
    draw = traffic.draw(cell.traffic, cell.cfg["family"], SEED)
    port = fleets.PortFleet(cell.cfg, device="cpu", backend="plain")
    carry = port.init(draw, 6, traffic.seed_of(SEED))
    mod = check.reference_module(cell.cfg["family"])
    r32 = mod.Fleet(cell.cfg, "cpu", ocp.Precision(torch.float32, False))
    r64 = mod.Fleet(cell.cfg, "cpu", ocp.REFERENCE)
    s32, s64 = r32.init(draw), r64.init(draw)
    for _ in range(3):
        carry, kkt = port.tick(carry)
        s32, k32 = r32.tick(s32)
        s64, k64 = r64.tick(s64)
        v = port.view(carry)
        for k in ("x0", "xs", "us"):
            torch.testing.assert_close(v[k], s32[k], rtol=1e-4, atol=agree)
            torch.testing.assert_close(v[k].double(), s64[k], rtol=1e-3,
                                       atol=2 * agree)
        torch.testing.assert_close(kkt, k32, rtol=1e-2, atol=agree / 10)


def test_tf32_rounding():
    """The control's rounding keeps 10 mantissa bits, to nearest."""
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-12, -(1.0 + 2**-10)])
    got = ocp.tf32_round(x)
    assert got.tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -(1.0 + 2**-10)]


def test_chol_solve():
    torch.manual_seed(0)
    for n in (2, 4):
        M = torch.randn(5, n, n, dtype=torch.float64)
        H = M @ M.transpose(-1, -2) + n * torch.eye(n, dtype=torch.float64)
        R = torch.randn(5, n, 3, dtype=torch.float64)
        torch.testing.assert_close(ocp.chol_solve(H, R), torch.linalg.solve(H, R))


# ------------------------------------------------------------ frozen counts


# PERF.md's bounds at B=16384, ms, to their four decimals, by configuration
# and horizon: the kernel table's bicycle sweep and 7x2 LQ at the bench's
# N=30 and the LQ at N=40, the fitted GP-quad sweep and the 13x4 LQ.
BOUNDS = {("c2", 30): {"vde": 0.0465, "lq_ipm": 0.1434},
          ("c2", 40): {"vde": 0.0620, "lq_ipm": 0.1912},
          ("c6-fitted", 10): {"vde": 0.0699, "lq_ipm": 0.4422}}


@pytest.mark.parametrize("config,N", sorted(BOUNDS))
def test_frozen_counts(config, N):
    """Each configuration's written counts follow from their derivation and
    reproduce the kernels' bounds at B=16384."""
    cfg = json.loads((ROOT / "configs" / f"{config}.json").read_text())
    cfg["ocp"]["n_nodes"] = N
    o, c = cfg["ocp"], cfg["counts"]
    vde = c["vde"]
    if "gp" in vde:
        assert yardstick.gp_quad_extra_per_evaluation(vde["gp"]) == vde["extra_per_evaluation"]
    assert yardstick.vde_flops_per_stage(vde, o["nx"], o["nu"]) == vde["flops_per_stage"]
    assert (yardstick.lq_flops_per_stage_iter(o["nx"], o["nu"])
            == c["lq_ipm"]["flops_per_stage_iter"])
    bounds = yardstick.kernel_bounds(cfg, 16384)
    for kernel in ("vde", "lq_ipm"):
        assert round(bounds[kernel][0], 4) == BOUNDS[(config, N)][kernel]


YARDSTICK = ["yardstick.py", "check.py", "traffic.py", "trace.py", "reference/ocp.py",
             "reference/bicycle_arcs.py", "reference/quad_circles.py", "metrics"]


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_yardstick_never_imports_the_port():
    """The reference, the counts, the comparison, the generator and the
    metrics' readers import nothing of the port, of JAX or of the JAX
    package, by their sources and once loaded."""
    files = []
    for p in YARDSTICK:
        files += sorted((ROOT / p).glob("*.py")) if (ROOT / p).is_dir() else [ROOT / p]
    banned = {"ad_mpc_tpu_torch", "ad_mpc_tpu", "jax", "jaxlib", "flax"}
    for f in files:
        assert not _imports(f) & banned, f
    code = ("import sys; import benchmark.yardstick, benchmark.check, benchmark.traffic, "
            "benchmark.trace, benchmark.reference.bicycle_arcs, "
            "benchmark.reference.quad_circles; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, capture_output=True,
                         text=True, check=True).stdout
    assert not set(json.loads(out.replace("'", '"'))) & banned


# ------------------------------------------------------------ the harness


def test_workloads_resolve_by_name():
    """Every cell finds its configuration, traffic, limits, reference and
    metrics' readers by the names in BENCHMARK.json."""
    for w in WORKLOADS:
        cell = load_cell(w)
        assert check.reference_module(cell.cfg["family"]).Fleet
        assert cell.traffic["batch"] > 0 and "gap_ratio" in cell.limits
        assert cell.cfg["name"] == next(x["config"] for x in BENCH["workloads"]
                                        if x["name"] == w)
        for m in cell.per_layer:
            assert callable(metric_reader(m["name"]))
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names


@pytest.mark.parametrize("workload", WORKLOADS)
def test_draw_is_the_seeds(workload):
    """A seed gives one draw and one sample, another seed other values of
    the same sizes, and the port draws the same fleet from the seed."""
    cell = load_cell(workload)
    spec, family = cell.traffic, cell.cfg["family"]
    a, b = traffic.draw(spec, family, SEED), traffic.draw(spec, family, SEED)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    c = traffic.draw(spec, family, SEED + 1)
    assert all(c[k].shape == a[k].shape and not np.array_equal(a[k], c[k]) for k in a)
    rows, fr = traffic.sample(spec, SEED)
    assert len(set(rows.tolist())) == spec["check"]["rows"] and np.all(np.diff(fr) >= 0)
    small = _small(workload, batch=64)
    port = fleets.PortFleet(cell.cfg, device="cpu", backend="plain")
    port.init(traffic.draw(small.traffic, family, SEED), 64, traffic.seed_of(SEED))


def test_no_card_fails():
    """Without a card the run exits with another code than 0 and prints no
    result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", WORKLOADS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=CHECKOUT,
                       env=env, capture_output=True, text=True)
    assert p.returncode != 0 and not p.stdout.strip()


def test_benchmark_alone_fails(tmp_path):
    """In a directory with BENCHMARK.json and the benchmark only, a run
    cannot find the system under test and fails."""
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import time; from benchmark.run import load_cell, run; "
            f"run(load_cell({WORKLOADS[0]!r}), 1, 1.0, False, device='cpu', "
            "t_start=time.time())")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True)
    assert p.returncode != 0 and "ad_mpc_tpu_torch" in p.stderr and not p.stdout.strip()


def test_sound_run_is_correct_and_loads_no_jax():
    out = _run(_small(BICYCLE))
    assert out["correct"], out["checks"]
    assert out["checked_rows"] > 0 and out["attempted"] == 8 * out["ticks"]
    assert not forbidden_modules()


def test_sound_quad_run_is_correct():
    out = _run(_small(QUAD, batch=4, warmup=3))
    assert out["correct"], out["checks"]


# ------------------------------------------------------------ the control and faults


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    """The reference a precision below the configuration's (TF32 products)
    in the program's place reads above the cell's limit."""
    cell = _small(workload, batch=8, warmup=3)
    out = run(cell, SEED, 1.0, False, device="cpu",
              fleet=fleets.ControlFleet(cell.cfg, "cpu"), t_start=time.time())
    assert not out["correct"]
    assert out["checks"]["gap_ratio"]["value"] > cell.limits["gap_ratio"]


class Faulty(fleets.PortFleet):
    """The port's fleet with its timed path broken underneath."""

    def __init__(self, cfg, fault):
        super().__init__(cfg, device="cpu", backend="plain")
        self.fault = fault

    def tick(self, carry):
        if self.fault == "unchanged":
            _, kkt = super().tick(carry)
            return carry, kkt
        new, kkt = super().tick(carry)
        if self.fault == "half_batch":
            # The second half of the fleet left out: its outputs are the
            # first half's mean.
            h = new[0].shape[0] // 2
            x = new[0].clone()
            x[h:] = x[:h].mean(0)
            return (x, *new[1:]), kkt
        if self.fault == "altered_answer":
            x = new[0].clone()
            x[1, 0] += 1e-3
            return (x, *new[1:]), kkt
        raise ValueError(self.fault)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered_answer"])
def test_faults_are_not_correct(fault):
    """A tick that returns its state unchanged, one that leaves out half
    the fleet, and one that alters an answer where it is produced: each
    comes out not correct. (One card: no exchange between chips to drop.)"""
    cell = _small(BICYCLE)
    out = _run(cell, fleet=Faulty(cell.cfg, fault))
    assert not out["correct"], out["checks"]


# ------------------------------------------------------------ the readers


def _trace():
    ops = [trace.DeviceOp("void lq_ipm_kernel<7, 2>(float const*)", 0.0, 3000.0, True),
           trace.DeviceOp("void vde_kernel<BicycleDyn>(float const*)", 3500.0, 3600.0, True),
           trace.DeviceOp("void rk4_kernel<BicycleDyn>(float const*)", 3600.0, 3620.0, True),
           trace.DeviceOp("void at::native::elementwise_kernel<128>()", 3700.0, 3800.0, True),
           trace.DeviceOp("Memcpy DtoH (Device -> Pinned)", 3800.0, 3850.0, False)]
    host = [("aten::cat", 3000.0, 3500.0), ("aten::copy_", 3100.0, 3200.0)]
    return trace.Trace(ops, host, ticks=1, wall_s=0.005)


def test_readers():
    cfg = json.loads((ROOT / "configs" / "c2.json").read_text())
    ctx = Context(_trace(), cfg, 16384, [1.0, 2.0, 3.0])
    read = lambda n: metric_reader(n)(ctx)
    bounds = yardstick.kernel_bounds(cfg, 16384)
    assert read("lq_ipm_roofline") == pytest.approx(100 * bounds["lq_ipm"][0] / 3.0)
    assert read("vde_roofline") == pytest.approx(100 * bounds["vde"][0] / 0.1)
    assert read("glue.device_ms_per_tick") == pytest.approx(0.1)
    assert read("glue.kernels_per_tick") == 4
    assert read("tick.enqueue_ms_p50") == 2.0
    assert read("device.idle_pct") == pytest.approx(100 * (1 - 3.27 / 5))
    assert trace.idle_gaps(ctx.trace)[0] == ["aten::cat", 500e-6]
    assert trace.device_ops(ctx.trace)[0][0].startswith("void lq_ipm_kernel")


def test_readers_find_nothing():
    """A reader with nothing to read returns nothing, never 0."""
    cfg = json.loads((ROOT / "configs" / "c2.json").read_text())
    empty = Context(trace.Trace([], [], 0, 0.0), cfg, 16384, [])
    for m in BENCH["per_layer"]:
        assert metric_reader(m["name"])(empty) is None, m["name"]


# ------------------------------------------------------------ on the card


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_card(workload):
    """A short run of each cell on the card prints the contract's line."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs the port's kernels")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload,
                        "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
                       cwd=CHECKOUT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}
    assert list(line)[-1] == "checks"
