"""The port's CUDA kernels against their plain PyTorch versions, on the card.

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest``: the repository's conftest configures JAX, which the
machine with the card need not have; nothing here imports JAX.) On a
machine without a CUDA device every test skips with its reason; the
decision is taken inside the ``cuda`` fixture, never at import.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from ad_mpc_tpu_torch import fleet
from ad_mpc_tpu_torch.control.mpc import bicycle_spec
from ad_mpc_tpu_torch.experiments import capture, long_horizon, mxu_riccati, quad_fleet
from ad_mpc_tpu_torch.experiments.c2_kernels import c3_c4_bits, c5_bits, c6_bits, digest
from ad_mpc_tpu_torch.models.gp_quad import GPQuadDynamics
from ad_mpc_tpu_torch.models.quadrotor import QuadDynamics
from ad_mpc_tpu_torch.ocp.solver import BatchedSQPSolver
from ad_mpc_tpu_torch.ops import _build
from ad_mpc_tpu_torch.ops.assoc_riccati import lqr_solve_assoc
from ad_mpc_tpu_torch.ops.cuda_chain import (
    chain_geometry, lane_chain_plain, make_lane_chain, to_lanes)
from ad_mpc_tpu_torch.ops import cuda_lq
from ad_mpc_tpu_torch.ops.cuda_lq import make_lq_solver
from ad_mpc_tpu_torch.ops.riccati import lqr_solve
from ad_mpc_tpu_torch.ops.cuda_vde import _entry, make_rk4, make_vde, vde_plain
from ad_mpc_tpu_torch.ops.integrators import discrete_step
from ad_mpc_tpu_torch.testing import (
    BOUNDS, LQ_WEIGHTS, QUAD_LQ_WEIGHTS, SPREAD_RUNS, f64_anchored,
    gp_bicycle_inputs, lq_case, pacejka_inputs, perturbed, quad_traj,
    random_lq, random_traj, table_perturbed)

pytestmark = pytest.mark.gpu

RAGGED_B = 37  # not a multiple of any block size
QUAD = QuadDynamics()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run python -m pytest --noconftest "
                    "-m gpu tests/test_torch_gpu.py on the GPU machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _traj(B, N, switch, device, seed=3):
    xs, us = (torch.as_tensor(a, device=device) for a in
              random_traj(np.random.default_rng(seed), B, N, 7, 2))
    return xs, us, torch.full((B, 1), switch, device=device)


@pytest.mark.parametrize("switch", [1.0, 0.3])
@pytest.mark.parametrize("B", [1, RAGGED_B])
def test_vde_kernel_matches_plain(cuda, switch, B):
    """B*N = 30 and 1110 rows: a single partial warp, and a ragged last
    warp of the output tile."""
    N = 30
    xs, us, ps = _traj(B, N, switch, cuda)
    vde = make_vde(fleet.dynamic_bicycle, 0.05, N, 7, 2, 1, device=cuda)
    got = vde(xs, us, ps)
    want = vde_plain(fleet.dynamic_bicycle, 0.05, 1, xs, us, ps)
    assert vde.launches == 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=0)


@pytest.mark.parametrize("switch", [1.0, 0.3])
def test_rk4_kernel_matches_plain(cuda, switch):
    """Both modes of the tangent-free entry against ``discrete_step``; the
    step takes u as the strided view ``us[:, 0]``, and the defect is the
    sweep's c."""
    N, dyn = 30, fleet.dynamic_bicycle
    xs, us, ps = _traj(RAGGED_B, N, switch, cuda)
    rk4 = make_rk4(dyn, 0.05, 7, 2, 1, device=cuda)
    defect = rk4.defect(xs, us, ps)
    step = rk4(xs[:, 0], us[:, 0], ps)
    assert rk4.launches == 2 and defect.shape == (RAGGED_B, N, 7)
    torch.testing.assert_close(
        defect, discrete_step(dyn, 0.05, 1, xs[:, :-1], us, ps[:, None])
        - xs[:, 1:], atol=2e-5, rtol=0)
    torch.testing.assert_close(
        step, discrete_step(dyn, 0.05, 1, xs[:, 0], us[:, 0], ps),
        atol=2e-5, rtol=0)
    c = make_vde(dyn, 0.05, N, 7, 2, 1, device=cuda)(xs, us, ps)[2]
    torch.testing.assert_close(defect, c, atol=2e-5, rtol=0)


def test_vde_and_rk4_repeat_their_bits(cuda):
    xs, us, ps = _traj(RAGGED_B, 30, 1.0, cuda, seed=8)
    vde = make_vde(fleet.dynamic_bicycle, 0.05, 30, 7, 2, 1, device=cuda)
    rk4 = make_rk4(fleet.dynamic_bicycle, 0.05, 7, 2, 1, device=cuda)
    for call in (lambda: vde(xs, us, ps), lambda: (rk4.defect(xs, us, ps),),
                 lambda: (rk4(xs[:, 0], us[:, 0], ps),)):
        first, second = call(), call()
        assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert vde.launches == 2 and rk4.launches == 4


def test_rk4_kernel_rejects_bad_input(cuda):
    xs, us, ps = _traj(4, 6, 1.0, cuda)
    rk4 = make_rk4(fleet.dynamic_bicycle, 0.05, 7, 2, 1, device=cuda)
    with pytest.raises(ValueError):
        rk4.defect(xs.double(), us, ps)
    with pytest.raises(ValueError):
        rk4.defect(xs[:, :-1], us, ps)
    with pytest.raises(ValueError):
        rk4(xs[:, 0], us[:, 0].T.contiguous().T, ps)  # last axis strided
    assert rk4.launches == 0


@pytest.mark.parametrize("N", [30, 10, 40])
@pytest.mark.parametrize("bounds_kind", ["bicycle", "unit"])
def test_lq_kernel_matches_plain(cuda, bounds_kind, N):
    """RAGGED_B is no multiple of the scenarios per block: the last block
    holds a partial team of scenarios."""
    Q, R = LQ_WEIGHTS
    ub, xb = BOUNDS[bounds_kind](7, 2)
    qp = make_lq_solver(N, 7, 2, Q, R, 1e-3 * Q, ub, xb, iters=12, device=cuda)
    assert RAGGED_B % qp.geometry.teams and qp.occupancy() >= 1
    args = [torch.as_tensor(a, device=cuda)
            for a in random_lq(np.random.default_rng(5), RAGGED_B, N, 7, 2)]
    dx, du, alpha = qp(*args)
    dx_w, du_w, _ = qp.plain(*args)
    assert qp.launches == 1
    torch.testing.assert_close(du, du_w, atol=3e-4, rtol=1e-3)
    torch.testing.assert_close(dx, dx_w, atol=3e-4, rtol=1e-3)
    assert bool(((alpha >= 0) & (alpha <= 1)).all())


def test_lq_kernel_repeats_its_bits(cuda):
    """Reductions run in a fixed order with no atomics: a second launch on
    the same inputs returns the same bits."""
    Q, R = LQ_WEIGHTS
    qp = make_lq_solver(30, 7, 2, Q, R, 1e-3 * Q, *BOUNDS["bicycle"](7, 2),
                        iters=12, device=cuda)
    args = [torch.as_tensor(a, device=cuda)
            for a in random_lq(np.random.default_rng(7), 1000, 30, 7, 2)]
    first, second = qp(*args), qp(*args)
    assert qp.launches == 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))


DIV_CHECK = r"""
__global__ void check(const float* a, const float* b, long long n,
                      unsigned long long* bad) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n;
       t += (long long)gridDim.x * blockDim.x) {
    const float q = fdiv(a[t], b[t]), s = fsqrt(fabsf(a[t]));
    if (__float_as_uint(q) != __float_as_uint(a[t] / b[t])) atomicAdd(bad, 1ULL);
    if (__float_as_uint(s) != __float_as_uint(sqrtf(fabsf(a[t]))))
      atomicAdd(bad + 1, 1ULL);
  }
}
extern "C" int run(const float* a, const float* b, long long n,
                   unsigned long long* bad) {
  check<<<1024, 256>>>(a, b, n, bad);
  return (int)cudaDeviceSynchronize();
}
"""


def test_lq_division_matches_ieee(cuda):
    """The branch-free fdiv and fsqrt of ``csrc/ieee_div.cuh`` (the LQ and
    VDE kernels' divisions) give the bits of IEEE '/' and sqrtf for normal
    operands with exponents in [-60, 60], the range of the solver's values
    (2**26 random pairs)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "lq_division_check.cu"
    cu.write_text(f'#include "{_build.CSRC / "ieee_div.cuh"}"\n' + DIV_CHECK)
    so = cu.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_void_p]
    gen = torch.Generator(device=cuda).manual_seed(0)
    n = 1 << 26

    def normal_floats():
        mant = torch.rand(n, device=cuda, generator=gen) + 1.0
        ex = torch.randint(-60, 61, (n,), device=cuda, generator=gen).float()
        sign = torch.where(torch.rand(n, device=cuda, generator=gen) < 0.5, -1.0, 1.0)
        return sign * mant * torch.exp2(ex)

    a, b = normal_floats(), normal_floats()
    bad = torch.zeros(2, dtype=torch.int64, device=cuda)
    assert lib.run(a.data_ptr(), b.data_ptr(), n, bad.data_ptr()) == 0
    assert bad.tolist() == [0, 0]


def test_lq_kernel_rejects_bad_input(cuda):
    Q, R = LQ_WEIGHTS
    ub, xb = BOUNDS["unit"](7, 2)
    qp = make_lq_solver(6, 7, 2, Q, R, Q, ub, xb, iters=2, device=cuda)
    args = [torch.as_tensor(a, device=cuda)
            for a in random_lq(np.random.default_rng(0), 4, 6, 7, 2)]
    with pytest.raises(ValueError):
        qp(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        qp(args[0][:, :5].contiguous(), *args[1:])
    assert qp.launches == 0


def test_fleet_tick_on_card_matches_plain(cuda):
    """Three c2 ticks at N=30 through the kernels agree with the plain path
    on the CPU; per tick the sweep and the QP launch once and the RK4 map
    twice (the KKT defect and the plant step)."""
    runs = {}
    for dev in ("cpu", cuda):
        tick, init, solver, _ = fleet.build_fleet(
            fleet.dynamic_bicycle, fleet.switch_on, device=dev)
        carry = init(RAGGED_B)
        for _ in range(3):
            carry, (kkt, lat) = tick(carry)
        runs[str(dev)] = (carry[0].cpu(), kkt.cpu(), float(lat), solver)
    (x_c, kkt_c, lat_c, _), (x_g, kkt_g, lat_g, solver) = runs.values()
    assert fleet.launches(solver) == {
        k: 3 * n for k, n in fleet.LAUNCHES_PER_TICK.items()}
    torch.testing.assert_close(x_g, x_c, atol=1e-4, rtol=1e-5)
    assert abs(lat_g - lat_c) < 1e-4
    assert float(kkt_g.max()) < 3e-5


def test_solver_checks_tf32(cuda):
    spec = bicycle_spec(t_horizon=0.5, n_nodes=10, qp_iters=4)
    solver = BatchedSQPSolver(spec, fleet.dynamic_bicycle, p_dim=1,
                              device=cuda)
    x0 = torch.zeros((2, 7), device=cuda)
    x0[:, 3] = 8.0
    st = solver.init_state(x0)
    args = (x0, st.xs.clone(), torch.zeros((2, 10, 2), device=cuda),
            torch.ones((2, 1), device=cuda), st)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError):
            solver.solve(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert solver.solve(*args).us.shape == (2, 10, 2)


@pytest.mark.parametrize("B", [16384, 1000, 37, 1])
def test_lane_chain_kernel_matches_plain(cuda, B):
    """A block carries 32 scenarios: B=1000 and 37 leave a ragged last
    block, B=1 a single lane."""
    A, X = mxu_riccati.inputs(B, 7, 0, cuda)
    a, x = to_lanes(A), to_lanes(X)
    lane = make_lane_chain(device=cuda)
    got = lane(a, x)
    want = lane_chain_plain(a, x, 12)
    assert lane.launches == 1
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    torch.testing.assert_close(lane(A, X), mxu_riccati.bmm_chain(A, X, 12),
                               atol=1e-5 * float(want.abs().max()), rtol=0)


def test_lane_chain_repeats_its_bits(cuda):
    A, X = mxu_riccati.inputs(RAGGED_B, 7, 1, cuda)
    a, x = to_lanes(A), to_lanes(X)
    lane = make_lane_chain(device=cuda)
    assert torch.equal(lane(a, x), lane(a, x)) and lane.launches == 2


def test_lane_chain_graph_replay_matches_eager(cuda):
    """A launch captured in a CUDA graph (as the MXU micro times it) gives
    the eager launch's bits on every replay; only the capture counts."""
    A, X = mxu_riccati.inputs(1000, 7, 2, cuda)
    a, x = to_lanes(A), to_lanes(X)
    lane = make_lane_chain(device=cuda)
    eager = lane(a, x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lane(a, x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = lane(a, x)
    assert lane.launches == 3
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert lane.launches == 3


def test_lane_chain_grid_is_one_wave(cuda):
    """At the micro's B=16384 every block of the launch is resident at once."""
    lane = make_lane_chain(device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert lane.occupancy() * sms >= chain_geometry(16384).blocks


def test_assoc_riccati_on_card_matches_sequential(cuda):
    """As ``tests/test_tpu_lowering.py:217-235``: float32 on the device,
    N=128, relative 2e-3 of max |du|."""
    ops = long_horizon.random_lq(np.random.default_rng(0), 128, device=cuda)
    _, du_s = lqr_solve(*ops)
    _, du_a = lqr_solve_assoc(*ops)
    err = float((du_s - du_a).abs().max()) / float(du_s.abs().max())
    assert err < 2e-3


def _quad_traj(B, N, device, seed=13):
    xs, us = (torch.as_tensor(a, device=device)
              for a in quad_traj(np.random.default_rng(seed), B, N))
    return xs, us, torch.zeros((B, 0), device=device)


@pytest.mark.parametrize("B", [1, RAGGED_B])
def test_vde_quad_kernel_matches_plain(cuda, B):
    """B*N = 10 and 370 rows: one partial warp, and a ragged last warp of
    the one-warp blocks; p_dim = 0, so the kernel gets a null ps."""
    N = 10
    xs, us, ps = _quad_traj(B, N, cuda)
    vde = make_vde(QUAD, 0.1, N, 13, 4, 0, device=cuda)
    got = vde(xs, us, ps)
    want = vde_plain(QUAD, 0.1, 1, xs, us, ps)
    assert vde.launches == 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=3e-5, rtol=0)


@pytest.mark.parametrize("B", [1, RAGGED_B])
def test_rk4_quad_kernel_matches_plain(cuda, B):
    N = 10
    xs, us, ps = _quad_traj(B, N, cuda, seed=14)
    rk4 = make_rk4(QUAD, 0.1, 13, 4, 0, device=cuda)
    defect = rk4.defect(xs, us, ps)
    step = rk4(xs[:, 0], us[:, 0], ps)
    assert rk4.launches == 2 and defect.shape == (B, N, 13)
    torch.testing.assert_close(
        defect, discrete_step(QUAD, 0.1, 1, xs[:, :-1], us, ps[:, None])
        - xs[:, 1:], atol=3e-5, rtol=0)
    torch.testing.assert_close(
        step, discrete_step(QUAD, 0.1, 1, xs[:, 0], us[:, 0], ps),
        atol=3e-5, rtol=0)
    c = make_vde(QUAD, 0.1, N, 13, 4, 0, device=cuda)(xs, us, ps)[2]
    torch.testing.assert_close(defect, c, atol=3e-5, rtol=0)


def _quad_qp(device):
    Q, R = QUAD_LQ_WEIGHTS
    return make_lq_solver(10, 13, 4, Q, R, 10 * Q, *BOUNDS["unit"](13, 4),
                          iters=18, device=device)


@pytest.mark.parametrize("B", [1, RAGGED_B, 1000])
def test_lq_13x4_kernel_matches_plain(cuda, B):
    """The quad's QP (N=10, 18 iterations, 8 hard cones) on random unit-box
    problems; RAGGED_B and 1000 leave a partial last block. Each scenario
    is held to the plain version at 3e-4 / 1e-3 (``testing.lq_case``):
    at B <= 37 every one to the float32 run, at B=1000 to the float64
    solution within 4x that scenario's float32 spread (a few of 1000
    random problems flip an active bound between two correct float32
    runs)."""
    qp = _quad_qp(cuda)
    assert qp.occupancy() >= 1
    args = [torch.as_tensor(a, device=cuda)
            for a in random_lq(np.random.default_rng(5), B, 10, 13, 4)]
    row, ok, _ = lq_case(qp, args, strict=B <= RAGGED_B)
    assert ok, row
    assert qp.launches == 2  # the case and its relaunch


def _mixed_13x4_bounds():
    """Soft and hard, one- and two-sided input bounds and state bounds (one
    soft): every kind of cone, 10 entries, where the quad has 8 hard ones."""
    nx, nu = 13, 4
    u = dict(lb=np.array([-0.2, 0.0, -np.inf, -0.5]),
             ub=np.array([0.3, np.inf, 0.4, 0.5]),
             soft=np.array([True, False, True, False]), zl=np.full(nu, 10.0),
             zu=np.full(nu, 10.0), Zl=np.full(nu, 1.0), Zu=np.zeros(nu))
    lbx, ubx = np.full(nx, -np.inf), np.full(nx, np.inf)
    lbx[0], ubx[0], lbx[12], ubx[5] = -0.3, 0.3, -0.2, 0.25
    soft = np.zeros(nx, bool)
    soft[5] = True
    x = dict(lb=lbx, ub=ubx, soft=soft, zl=np.full(nx, 5.0), zu=np.full(nx, 5.0),
             Zl=np.zeros(nx), Zu=np.full(nx, 2.0))
    return u, x


@pytest.mark.parametrize("bounds", ["unit", "mixed"])
@pytest.mark.parametrize("N", [10, 24])
def test_lq_13x4_kernel_matches_plain_at_horizons(cuda, N, bounds):
    """The 13x4 kernel against its plain version at 3e-4 / 1e-3
    (``tests/test_pallas_lq.py``'s tolerance) at a ragged B, at the quad's
    N=10 and at N=24 (where the ring of cone weights is refilled
    mid-sweep): with the quad's hard input box every
    scenario against the float32 run; with every kind of cone, where a few
    of these random problems flip an active bound between two correct
    float32 runs (6 and 9 of 37 in a CPU emulation of the kernel), each
    scenario against the float64 solution within 4x its own float32 spread
    (``testing.lq_case``)."""
    Q, R = QUAD_LQ_WEIGHTS
    bnd = _mixed_13x4_bounds() if bounds == "mixed" else BOUNDS["unit"](13, 4)
    qp = make_lq_solver(N, 13, 4, Q, R, 10 * Q, *bnd, iters=18, device=cuda)
    assert RAGGED_B % qp.geometry_for(RAGGED_B).teams
    assert qp.occupancy(RAGGED_B) >= 1
    args = [torch.as_tensor(a, device=cuda)
            for a in random_lq(np.random.default_rng(N), RAGGED_B, N, 13, 4)]
    row, ok, _ = lq_case(qp, args, strict=bounds == "unit")
    assert ok, row


def test_lq_13x4_graph_replay_matches_eager(cuda):
    """At c5's B=16384 geometry (8 scenarios per block) the kernel launches
    under CUDA-graph capture (the wrapper sets no attribute there) and every
    replay gives the eager launch's bits; only the capture counts."""
    qp = _quad_qp(cuda)
    assert qp.geometry_for(16384).teams == 8
    args = [torch.as_tensor(a, device=cuda)
            for a in random_lq(np.random.default_rng(3), 16384, 10, 13, 4)]
    eager = qp(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qp(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qp(*args)
    assert qp.launches == 3
    for _ in range(2):
        for o in out:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, e) for o, e in zip(out, eager))
    assert qp.launches == 3


@pytest.mark.parametrize("shape", [(7, 2), (13, 4)])
def test_lq_layout_matches_the_kernel(cuda, shape):
    """``cuda_lq.scenario_floats`` mirrors the kernels' own layouts
    (``Layout``, ``lq_wide::Layout``), which the C entry reports."""
    nx, nu = shape
    lib = cuda_lq._lib()
    for N in (10, 24, 40):
        for nc in (0, 8, 32):
            assert lib.lq_ipm_scenario_floats(N, nx, nu, nc) == \
                cuda_lq.scenario_floats(N, nx, nu, nc)


def test_quad_kernels_repeat_their_bits(cuda):
    xs, us, ps = _quad_traj(RAGGED_B, 10, cuda, seed=8)
    vde = make_vde(QUAD, 0.1, 10, 13, 4, 0, device=cuda)
    rk4 = make_rk4(QUAD, 0.1, 13, 4, 0, device=cuda)
    qp = _quad_qp(cuda)
    args = [torch.as_tensor(a, device=cuda)
            for a in random_lq(np.random.default_rng(7), RAGGED_B, 10, 13, 4)]
    for call in (lambda: vde(xs, us, ps), lambda: (rk4.defect(xs, us, ps),),
                 lambda: (rk4(xs[:, 0], us[:, 0], ps),), lambda: qp(*args)):
        first, second = call(), call()
        assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert vde.launches == 2 and rk4.launches == 4 and qp.launches == 2


def test_quad_kernels_refuse_another_shape(cuda):
    """A sweep of another (nx, nu) than its functor's is refused by the
    wrapper and by the C entry, which also refuses fewer parameter entries
    than its functor reads; the LQ kernel has no 13x2 instantiation."""
    with pytest.raises(ValueError):
        make_vde(QUAD, 0.1, 10, 7, 2, 0, device=cuda)
    with pytest.raises(ValueError):
        make_rk4(fleet.dynamic_bicycle, 0.05, 13, 4, 1, device=cuda)
    B, N = 4, 10
    xs, us, _ = _quad_traj(B, N, cuda)
    A = torch.empty((B, N, 13, 13), device=cuda)
    Bm = torch.empty((B, N, 13, 4), device=cuda)
    c = torch.empty((B, N, 13), device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for f, nx, nu, pd in ((QUAD, 7, 2, 0), (QUAD, 13, 2, 0),
                          (fleet.dynamic_bicycle, 7, 2, 0)):
        fn, _ = _entry(f)
        err = fn(xs.data_ptr(), us.data_ptr(), None, A.data_ptr(), Bm.data_ptr(),
                 c.data_ptr(), B, N, nx, nu, pd, 0.1, 1, f.cuda_params(), stream)
        assert err != 0
    Q, R = np.eye(13), np.eye(2)
    qp = make_lq_solver(6, 13, 2, Q, R, Q, *BOUNDS["unit"](13, 2), iters=2,
                        device=cuda)
    args = [torch.as_tensor(a, device=cuda)
            for a in random_lq(np.random.default_rng(0), 4, 6, 13, 2)]
    with pytest.raises(NotImplementedError):
        qp(*args)
    assert qp.launches == 0


def test_c5_ticks_on_card_match_plain(cuda):
    """Three c5 ticks through the kernels agree with the plain path on the
    CPU; per tick the sweep and the QP launch twice (two Gauss-Newton
    iterations) and the RK4 map twice."""
    runs = {}
    for dev in ("cpu", cuda):
        tick, init, solver, _ = quad_fleet.build_quad_fleet(device=dev)
        carry = init(RAGGED_B)
        for _ in range(3):
            carry, (kkt, lat) = tick(carry)
        runs[str(dev)] = (carry[0].cpu(), kkt.cpu(), float(lat), solver)
    (x_c, kkt_c, lat_c, _), (x_g, kkt_g, lat_g, solver) = runs.values()
    assert fleet.launches(solver) == {
        k: 3 * n for k, n in quad_fleet.LAUNCHES_PER_TICK.items()}
    torch.testing.assert_close(x_g, x_c, atol=1e-4, rtol=1e-5)
    assert abs(lat_g - lat_c) < 1e-4
    torch.testing.assert_close(kkt_g, kkt_c, rtol=1e-2, atol=1e-6)


# sha256 of the c2 kernels' outputs on a fixed draw, as the kernels gave
# them before the quad functor and the 13x4 instantiation were added
# (``experiments/c2_kernels.py`` run on that tree).
C2_BITS = {"vde": "bc398bce5b68c93b", "lq_ipm": "76dfceaa42f12086"}


def test_c2_kernels_keep_their_bits(cuda):
    xs, us, ps = _traj(RAGGED_B, 30, 1.0, cuda, seed=8)
    vde = make_vde(fleet.dynamic_bicycle, 0.05, 30, 7, 2, 1, device=cuda)
    Q, R = LQ_WEIGHTS
    qp = make_lq_solver(30, 7, 2, Q, R, 1e-3 * Q, *BOUNDS["bicycle"](7, 2),
                        iters=12, device=cuda)
    args = [torch.as_tensor(a, device=cuda)
            for a in random_lq(np.random.default_rng(7), RAGGED_B, 30, 7, 2)]
    got = {"vde": digest(*vde(xs, us, ps)), "lq_ipm": digest(*qp(*args))}
    assert got == C2_BITS


# sha256 of the c5 kernels' outputs on the fixed draws of
# ``experiments/c2_kernels.py:c5_bits``, as the kernels gave them before the
# Pacejka and GP-bicycle functors were added (that script run on that tree).
C5_BITS = {"vde_quad": "4f3a54a5b54acb2f", "rk4_quad": "28f653bd12ad4924",
           "lq_ipm_13x4": "a9063230cda71da4"}


def test_c5_kernels_keep_their_bits(cuda):
    assert c5_bits(cuda) == C5_BITS


def _bicycle_kernels_match_plain(dyn, xs, us, ps):
    """The VDE sweep and both modes of the RK4 map of ``dyn`` against their
    plain versions at 2e-5 (``tests/test_pallas_vde.py:81-83, 222-224``)."""
    B, N = us.shape[:2]
    vde = make_vde(dyn, 0.05, N, 7, 2, ps.shape[1], device=ps.device)
    rk4 = make_rk4(dyn, 0.05, 7, 2, ps.shape[1], device=ps.device)
    got = vde(xs, us, ps)
    for g, w in zip(got, vde_plain(dyn, 0.05, 1, xs, us, ps)):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=0)
    defect = rk4.defect(xs, us, ps)
    torch.testing.assert_close(
        defect, discrete_step(dyn, 0.05, 1, xs[:, :-1], us, ps[:, None])
        - xs[:, 1:], atol=2e-5, rtol=0)
    torch.testing.assert_close(
        rk4(xs[:, 0], us[:, 0], ps),
        discrete_step(dyn, 0.05, 1, xs[:, 0], us[:, 0], ps), atol=2e-5, rtol=0)
    torch.testing.assert_close(defect, got[2], atol=2e-5, rtol=0)
    assert vde.launches == 1 and rk4.launches == 2
    assert torch.equal(vde(xs, us, ps)[0], got[0])  # a relaunch repeats its bits


@pytest.mark.parametrize("low_mu", [False, True])
@pytest.mark.parametrize("B", [1, RAGGED_B])
def test_pacejka_kernels_match_plain(cuda, B, low_mu):
    """c4's functor on p drawn by ``p_of``, and at the sweep's lowest
    friction; B*N = 30 and 1110 rows (a partial and a ragged last warp)."""
    dyn, (xs, us, ps) = pacejka_inputs(B, 30, cuda)
    if low_mu:
        ps[:, 0] = 0.6
    _bicycle_kernels_match_plain(dyn, xs, us, ps)


@pytest.mark.parametrize("n", [32, 8])
@pytest.mark.parametrize("B", [1, RAGGED_B])
def test_gp_bicycle_kernels_match_plain(cuda, B, n):
    """c3's functor with the bench's 32-point ensemble and its 8-point
    twin."""
    dyn, (xs, us, ps) = gp_bicycle_inputs(B, 30, cuda, n)
    _bicycle_kernels_match_plain(dyn, xs, us, ps)


@pytest.mark.parametrize("config", ["c3", "c4"])
def test_c3_c4_ticks_on_card_match_plain(cuda, config):
    """Three ticks of the c3 and c4 fleets through the kernels agree with
    the plain path on the CPU (u0 within 1e-3); per tick the sweep and the
    QP launch once and the RK4 map twice."""
    if config == "c3":
        dyn, p_of, v_cap = fleet.make_gp_bicycle(), fleet.switch_on, None
    else:
        dyn, p_of, v_cap = fleet.make_pacejka()
    runs = {}
    for dev in ("cpu", cuda):
        tick, init, solver, _ = fleet.build_fleet(dyn, p_of, v_cap=v_cap,
                                                  device=dev)
        carry = init(RAGGED_B)
        for _ in range(3):
            carry, (kkt, lat) = tick(carry)
        runs[str(dev)] = (carry[0].cpu(), carry[5].us[:, 0].cpu(), float(lat),
                          solver)
    (x_c, u_c, lat_c, _), (x_g, u_g, lat_g, solver) = runs.values()
    assert fleet.launches(solver) == {
        k: 3 * n for k, n in fleet.LAUNCHES_PER_TICK.items()}
    torch.testing.assert_close(u_g, u_c, atol=1e-3, rtol=0)
    torch.testing.assert_close(x_g, x_c, atol=1e-4, rtol=1e-5)
    assert abs(lat_g - lat_c) < 1e-4


# sha256 of the c3 and c4 functors' outputs on the fixed draws of
# ``experiments/c2_kernels.py:c3_c4_bits``, as the kernels gave them before
# the GP-quad functor was added (that script run on that tree).
C3_C4_BITS = {"vde_gp_bicycle": "d61ba90e3c0ede6f", "rk4_gp_bicycle": "f0f9cd2cfa3b8a28",
              "vde_pacejka": "52c56946f655b919", "rk4_pacejka": "c25859d3cf9ff011"}


def test_c3_c4_kernels_keep_their_bits(cuda):
    assert c3_c4_bits(cuda) == C3_C4_BITS


# sha256 of the c6 functor's outputs on the fixed draws of
# ``experiments/c2_kernels.py:c6_bits``, as the kernels gave them before
# GPQuadDyn's means cache and rotation were shared with GPQuadDualDyn (that
# function run on that tree and on this one, on one card).
C6_BITS = {"vde_gp_quad_n32": "6d7be73b6e468547", "rk4_gp_quad_n32": "59b2ab82177f4066",
           "vde_gp_quad_fitted": "b88df69fcf79e808",
           "rk4_gp_quad_fitted": "d40b726b227d43c3"}


def test_c6_kernels_keep_their_bits(cuda):
    assert c6_bits(cuda) == C6_BITS


def _gp_quad(fitted):
    ens = (quad_fleet.fitted_ensemble() if fitted
           else quad_fleet.make_quad_gp_ensemble())
    return GPQuadDynamics(ens)


@pytest.mark.parametrize("fitted", [False, True], ids=["n32", "fitted_n60"])
@pytest.mark.parametrize("B", [1, RAGGED_B])
def test_gp_quad_kernels_match_plain(cuda, B, fitted):
    """c6's functor: the VDE sweep and both modes of the RK4 map against
    their plain versions at 3e-5 on the synthetic 32-point ensemble; on the
    fitted 60-point model, whose float32 rounding alone moves a step by
    about 1e-4 (``tests/test_torch_gp_quad.py``), against the float64 plain
    versions, each row of A and Bm and each entry of c and of the RK4 map
    within 3e-5 plus 4 times the float32 plain versions' spread there, on
    the inputs and on copies of the inputs and of the GP table moved by an
    ulp (``testing.f64_anchored``)."""
    N, dyn = 10, _gp_quad(fitted)
    xs, us, ps = _quad_traj(B, N, cuda)
    vde = make_vde(dyn, 0.1, N, 13, 4, 0, device=cuda)
    rk4 = make_rk4(dyn, 0.1, 13, 4, 0, device=cuda)
    got = (*vde(xs, us, ps), rk4.defect(xs, us, ps), rk4(xs[:, 0], us[:, 0], ps))
    assert vde.launches == 1 and rk4.launches == 2

    def plain(dyn, xs, us, ps):
        return (*vde_plain(dyn, 0.1, 1, xs, us, ps),
                discrete_step(dyn, 0.1, 1, xs[:, :-1], us, ps[:, None]) - xs[:, 1:],
                discrete_step(dyn, 0.1, 1, xs[:, 0], us[:, 0], ps))

    args = (xs, us, ps)
    want = plain(dyn, *args)
    if fitted:
        want64 = plain(dyn, *(a.double() for a in args))
        runs = [want] + [plain(table_perturbed(dyn, s), *perturbed(args, s))
                         for s in range(SPREAD_RUNS)]
        for i, (g, w64) in enumerate(zip(got, want64)):
            err, spread, ratio, ok = f64_anchored(
                g, [r[i] for r in runs], w64, 3e-5, rows=i < 2)
            assert ok, (i, err, spread, ratio)
    else:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=3e-5, rtol=0)
    if not fitted:  # the RK4 map's defect is the sweep's c
        torch.testing.assert_close(got[3], got[2], atol=3e-5, rtol=0)
    assert torch.equal(vde(xs, us, ps)[0], got[0])  # a relaunch repeats its bits


def test_c6_ticks_on_card_match_plain(cuda):
    """Three c6 ticks (the synthetic ensemble) through the kernels agree
    with the plain path on the CPU, u0 within 1e-3; per tick the sweep and
    the QP launch twice and the RK4 map twice."""
    ens = quad_fleet.make_quad_gp_ensemble()
    runs = {}
    for dev in ("cpu", cuda):
        tick, init, solver, _ = quad_fleet.build_quad_fleet(device=dev,
                                                            ensemble=ens)
        carry = init(RAGGED_B)
        for _ in range(3):
            carry, (kkt, lat) = tick(carry)
        runs[str(dev)] = (carry[0].cpu(), carry[5].us[:, 0].cpu(), kkt.cpu(),
                          float(lat), solver)
    (x_c, u_c, kkt_c, lat_c, _), (x_g, u_g, kkt_g, lat_g, solver) = runs.values()
    assert fleet.launches(solver) == {
        k: 3 * n for k, n in quad_fleet.LAUNCHES_PER_TICK.items()}
    torch.testing.assert_close(u_g, u_c, atol=1e-3, rtol=0)
    torch.testing.assert_close(x_g, x_c, atol=1e-4, rtol=1e-5)
    assert abs(lat_g - lat_c) < 1e-4
    torch.testing.assert_close(kkt_g, kkt_c, rtol=1e-2, atol=1e-6)


def test_long_horizon_replay_matches_eager(cuda):
    """The long-horizon micro's block of chained solves, captured in a CUDA
    graph, gives the eager block's bits on every replay, for both Riccati
    backends."""
    ops = long_horizon.random_lq(np.random.default_rng(1), 30, device=cuda)
    for solve in (lqr_solve, lqr_solve_assoc):
        with long_horizon.cusolver():
            graph, x, ref, _ = capture(long_horizon.solve_block(solve, ops, 3),
                                       ops[-1])
            for _ in range(2):
                x.copy_(ops[-1])
                graph.replay()
                torch.cuda.synchronize()
                assert torch.equal(x, ref)


# The single-vehicle AD path: SQPSolver, BicycleMPC and the closed loop at
# B=1 through the VDE, LQ and RK4 kernels.

def _ad_solvers(device, N, qp_iters, **spec_kw):
    """(kernels, plain on the card, spec) for the bicycle at horizon N."""
    import dataclasses

    from ad_mpc_tpu_torch.ocp.solver import SQPSolver

    spec = dataclasses.replace(
        bicycle_spec(t_horizon=0.05 * N, n_nodes=N, qp_iters=qp_iters), **spec_kw)
    dyn = fleet.dynamic_bicycle
    return (SQPSolver(spec, dyn, p_dim=1, device=device, backend="cuda"),
            SQPSolver(spec, dyn, p_dim=1, device=device, backend="plain"), spec)


def _ad_problem(device, N, seed=11):
    from ad_mpc_tpu_torch.testing import bike_instance

    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in bike_instance(np.random.default_rng(seed), N, 0.05)]


@pytest.mark.parametrize("N,qp_iters", [(40, 18), (20, 10)])
def test_ad_solver_b1_kernels_match_plain(cuda, N, qp_iters):
    """One RTI solve at B=1: each kernel held to its plain version on the
    inputs the solve gave it (the sweep at 2e-5, the QP by ``lq_case``,
    strict), u0 within 1e-3 of the plain solver's, and one launch of each
    kernel per solve."""
    kern, plain, _ = _ad_solvers(cuda, N, qp_iters)
    x0, yref, yu, p = _ad_problem(cuda, N)
    st = plain.init_state(x0)
    seen = {}
    hooks = [m.register_forward_pre_hook(lambda mod, a, k=k: seen.setdefault(k, a))
             for k, m in (("vde", kern.vde), ("qp", kern.qp))]
    try:
        got = kern.solve(x0, yref, yu, p, st)
    finally:
        for h in hooks:
            h.remove()
    want = plain.solve(x0, yref, yu, p, st)
    assert fleet.launches(kern) == {"vde": 1, "lq_ipm": 1, "rk4": 1}
    assert fleet.launches(plain) == {"vde": 0, "lq_ipm": 0, "rk4": 0}
    for g, w in zip(kern.vde(*seen["vde"]), kern.vde.plain(*seen["vde"])):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=0)
    row, ok, _ = lq_case(kern.qp, seen["qp"], strict=True)
    assert ok, row
    assert float((got.us[0] - want.us[0]).abs().max()) < 1e-3
    assert abs(float(got.kkt_residual) - float(want.kkt_residual)) < 1e-5


def test_ad_per_stage_route_gives_the_broadcast_bits(cuda):
    """Per-stage p runs the sweep and the defect as N one-stage scenarios:
    with every row equal to the broadcast p, the solve gives the B=1
    launch's bits."""
    N = 40
    kern, _, _ = _ad_solvers(cuda, N, 18)
    x0, yref, yu, p = _ad_problem(cuda, N, seed=12)
    st = kern.init_state(x0)
    one = kern.solve(x0, yref, yu, p, st)
    rows = kern.solve(x0, yref, yu, p.expand(N, 1).contiguous(), st)
    assert torch.equal(one.us, rows.us) and torch.equal(one.xs, rows.xs)
    assert torch.equal(one.kkt_residual, rows.kkt_residual)
    xs, us = st.xs[None].contiguous(), st.us[None].contiguous()
    b1 = kern.vde(xs, us, p[None])
    pairs = torch.stack([st.xs[:-1], st.xs[1:]], dim=1)
    stages = kern.vde(pairs, st.us[:, None].contiguous(), p.expand(N, 1).contiguous())
    assert all(torch.equal(a[0], b[:, 0]) for a, b in zip(b1, stages))


def test_ad_point_reference_mode_on_card(cuda):
    """Full SQP with the line search (10 Gauss-Newton iterations, 6
    candidates): u0 within 1e-3 of the plain solver's; per solve 10 sweeps,
    10 QPs, and N RK4 launches per iteration plus the defect."""
    N = 20
    kern, plain, _ = _ad_solvers(cuda, N, 18, sqp_iters=10, ls_steps=6)
    x0, yref, yu, p = _ad_problem(cuda, N, seed=13)
    st = plain.init_state(x0)
    got, want = kern.solve(x0, yref, yu, p, st), plain.solve(x0, yref, yu, p, st)
    assert fleet.launches(kern) == {"vde": 10, "lq_ipm": 10, "rk4": 10 * N + 1}
    assert float((got.us[0] - want.us[0]).abs().max()) < 1e-3


def test_ad_fused_step_makes_no_host_sync(cuda):
    """The node's fused step (solve, shift, gates, backup selection,
    steering command) runs with every host synchronisation an error."""
    from ad_mpc_tpu_torch.control.mpc import BicycleMPC

    N = 40
    mpc = BicycleMPC(spec=bicycle_spec(), device=cuda)
    x0, yref, _, _ = _ad_problem(cuda, N, seed=14)
    packed = torch.cat([x0[None], yref]).contiguous()
    step = mpc.make_fused_step()
    carry = mpc.fused_init(x0)
    step(packed, *carry)  # first call outside: allocator warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            out, *carry = step(packed, *carry)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.shape == (4,) and bool(torch.isfinite(out).all())
    mpc.set_reference(yref.cpu().numpy())
    us, _, ok = mpc.optimize(x0.cpu())
    assert us.shape == (N, 2)


def test_ad_closed_loop_on_card(cuda):
    """40 ticks of the oval at N=40 through the kernels: the track is held
    and every tick launched the sweep, the QP and the defect once (plus the
    cold start's N RK4 rollout steps)."""
    from ad_mpc_tpu_torch.experiments.ad_closed_loop import run_closed_loop

    res = run_closed_loop(sim_time=2.0, device=cuda)
    assert res.rmse_pos < 0.5
    assert res.launches == {"vde": 40, "lq_ipm": 40, "rk4": 40 + 40}


def test_sqp_solver_cuda_refuses_float64(cuda):
    from ad_mpc_tpu_torch.ocp.solver import SQPSolver

    with pytest.raises(ValueError, match="float32"):
        SQPSolver(bicycle_spec(n_nodes=20, t_horizon=1.0), fleet.dynamic_bicycle,
                  p_dim=1, dtype=torch.float64, device=cuda)


def test_ad_rti_converges_to_oracle_on_card(cuda):
    """``tests/test_acados_parity.py:test_rti_converges_to_oracle`` through
    the kernels: 30 RTI re-solves without shift on the committed oracle
    instance end within 1e-3 of the oracle's u0."""
    import os

    from ad_mpc_tpu_torch.testing import rti_oracle_distance

    path = os.path.join(os.path.dirname(__file__), "fixtures", "oracle_bike_n20.npz")
    d, launches = rti_oracle_distance(path, cuda, backend="cuda")
    assert d < 1e-3, d
    assert launches == {"vde": 30, "lq_ipm": 30, "rk4": 30 + 20}


# QuadMPC's modes on the card: the RDRv drag (QuadDragDyn) and the
# dual-state GP (GPQuadDualDyn) functors, and one solve per mode.

def _drag():
    from ad_mpc_tpu_torch.models.quadrotor import QuadDragDynamics

    return QuadDragDynamics(quad_fleet.fitted_rdrv_d())


def _dual(name):
    from ad_mpc_tpu_torch.models.gp_quad import GPQuadDualDynamics

    ens = (quad_fleet.fitted_ensemble() if name == "fitted"
           else quad_fleet.make_quad_gp_ensemble(n=16, clusters=2))
    return GPQuadDualDynamics(ens)


def _new_functor_outputs(dyn, xs, us, ps, device):
    vde = make_vde(dyn, 0.1, xs.shape[1] - 1, 13, 4, ps.shape[1], device=device)
    rk4 = make_rk4(dyn, 0.1, 13, 4, ps.shape[1], device=device)
    got = (*vde(xs, us, ps), rk4.defect(xs, us, ps), rk4(xs[:, 0], us[:, 0], ps))
    assert vde.launches == 1 and rk4.launches == 2
    return got


def _plain_outputs(dyn, xs, us, ps):
    return (*vde_plain(dyn, 0.1, 1, xs, us, ps),
            discrete_step(dyn, 0.1, 1, xs[:, :-1], us, ps[:, None]) - xs[:, 1:],
            discrete_step(dyn, 0.1, 1, xs[:, 0], us[:, 0], ps))


def _hold_to_plain(dyn, got, args, anchored):
    """The outputs of :func:`_new_functor_outputs` against
    :func:`_plain_outputs` at 3e-5; ``anchored`` (a fitted GP) each held to
    the float64 plain version with its float32 spread instead
    (``testing.f64_anchored``; the sweep's outputs by rows)."""
    if not anchored:
        for g, w in zip(got, _plain_outputs(dyn, *args)):
            torch.testing.assert_close(g, w, atol=3e-5, rtol=0)
        return
    want64 = _plain_outputs(dyn, *(a.double() for a in args))
    runs = [_plain_outputs(dyn, *args)] + [
        _plain_outputs(table_perturbed(dyn, s), *perturbed(args, s))
        for s in range(SPREAD_RUNS)]
    for i, (g, w64) in enumerate(zip(got, want64)):
        err, spread, ratio, ok = f64_anchored(
            g, [r[i] for r in runs], w64, 3e-5, rows=i < 2)
        assert ok, (i, err, spread, ratio)


@pytest.mark.parametrize("B", [1, RAGGED_B])
def test_quad_drag_kernels_match_plain(cuda, B):
    """The drag functor's sweep and both modes of its RK4 map against their
    plain versions at the quad's 3e-5; a relaunch repeats its bits."""
    dyn = _drag()
    xs, us, ps = _quad_traj(B, 10, cuda, seed=15)
    xs[..., 7:10] *= 10.0  # velocities where the drag matters
    got = _new_functor_outputs(dyn, xs, us, ps, cuda)
    for g, w in zip(got, _plain_outputs(dyn, xs, us, ps)):
        torch.testing.assert_close(g, w, atol=3e-5, rtol=0)
    torch.testing.assert_close(got[3], got[2], atol=3e-5, rtol=0)
    again = _new_functor_outputs(dyn, xs, us, ps, cuda)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("name", ["two_clusters", "fitted"])
@pytest.mark.parametrize("B", [1, RAGGED_B, 1000])
def test_gp_quad_dual_kernels_match_plain(cuda, B, name):
    """The dual-state functor on p rows with the trigger on every third
    scenario and the cluster drawn per output: on the synthetic two-cluster
    three-output ensemble (each scenario's cluster read from its p) at
    3e-5, on the fitted one-cluster model held to the float64 plain
    version with its float32 spread (``testing.f64_anchored``)."""
    from ad_mpc_tpu_torch.testing import dual_gp_ps

    dyn = _dual(name)
    xs, us, _ = _quad_traj(B, 10, cuda, seed=16)
    xs[..., 7:10] *= 10.0 if name == "two_clusters" else 5.0
    ps = torch.as_tensor(dual_gp_ps(np.random.default_rng(B), B, dyn.ensemble,
                                     trigger_every=3), device=cuda)
    got = _new_functor_outputs(dyn, xs, us, ps, cuda)
    if name == "two_clusters":
        assert len(set(ps[:, 4:].flatten().tolist())) == 2
    _hold_to_plain(dyn, got, (xs, us, ps), anchored=name == "fitted")
    again = _new_functor_outputs(dyn, xs, us, ps, cuda)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_gp_quad_dual_refuses_a_p_of_another_width(cuda):
    """The C entry checks p against the struct's D (1 + 2D entries)."""
    dyn = _dual("two_clusters")
    B, N = 4, 10
    xs, us, _ = _quad_traj(B, N, cuda)
    A = torch.empty((B, N, 13, 13), device=cuda)
    Bm = torch.empty((B, N, 13, 4), device=cuda)
    c = torch.empty((B, N, 13), device=cuda)
    ps = torch.zeros((B, 5), device=cuda)
    fn, _ = _entry(dyn)
    err = fn(xs.data_ptr(), us.data_ptr(), ps.data_ptr(), A.data_ptr(),
             Bm.data_ptr(), c.data_ptr(), B, N, 13, 4, 5, 0.1, 1,
             dyn.cuda_params(), torch.cuda.current_stream(cuda).cuda_stream)
    assert err != 0


def _quad_modes():
    from ad_mpc_tpu_torch.learned.ensemble import quad_residual_fn

    fitted = quad_fleet.fitted_ensemble()
    return {"nominal": {}, "rdrv": {"rdrv_d": quad_fleet.fitted_rdrv_d()},
            "residual_fn": {"residual_fn": quad_residual_fn(fitted)},
            "ensemble": {"ensemble": fitted}}


@pytest.mark.parametrize("mode", ["nominal", "rdrv", "residual_fn", "ensemble"])
def test_quad_mpc_solve_on_card_matches_plain(cuda, mode):
    """One RTI solve of each mode through the kernels against the plain
    solver on the card from the same warm start: u0 within 1e-3, and one
    launch each of the sweep, the 13x4 QP and the RK4 map per solve."""
    from ad_mpc_tpu_torch.control.mpc import QuadMPC, quad_spec
    from ad_mpc_tpu_torch.experiments.quad_trajectory_test import (
        get_reference_chunk, reference)
    from ad_mpc_tpu_torch.ocp.solver import SolverState

    traj, t_ref, u_traj = reference("loop", 8.0)
    x_ref, u_ref = get_reference_chunk(traj, u_traj, t_ref, 6.0, 10, 0.1)
    x0 = torch.as_tensor(traj[300], dtype=torch.float32, device=cuda)
    kw = _quad_modes()[mode]
    kern, plain = (QuadMPC(spec=quad_spec(qp_iters=15), device=cuda, backend=b, **kw)
                   for b in ("cuda", "plain"))
    start = plain.solver.init_state(x0)
    for m in (kern, plain):
        m.set_reference(x_ref, u_ref)
        m.state = SolverState(start.xs.clone(), start.us.clone())
    kern.solver.vde.launches = kern.solver.qp.launches = kern.solver.rk4.launches = 0
    got, _ = kern.optimize(x0)
    want, _ = plain.optimize(x0)
    assert fleet.launches(kern.solver) == {"vde": 1, "lq_ipm": 1, "rk4": 1}
    assert fleet.launches(plain.solver) == {"vde": 0, "lq_ipm": 0, "rk4": 0}
    assert float((got[0] - want[0]).abs().max()) < 1e-3


@pytest.mark.parametrize("mode", ["nominal", "rdrv", "residual_fn", "ensemble"])
def test_quad_mpc_kernels_match_plain_at_the_solve_inputs(cuda, mode):
    """Each mode's sweep and RK4 map on the inputs one RTI solve gave them
    (B=1, N=10; the dual-state GP's N one-stage scenarios with their
    trigger and cluster p rows) against their plain versions: 3e-5, the
    fitted GP's modes held to the float64 plain version with their float32
    spread (``testing.f64_anchored``)."""
    from ad_mpc_tpu_torch.control.mpc import QuadMPC, quad_spec
    from ad_mpc_tpu_torch.experiments.quad_trajectory_test import (
        get_reference_chunk, reference)

    traj, t_ref, u_traj = reference("loop", 8.0)
    mpc = QuadMPC(spec=quad_spec(qp_iters=15), device=cuda, **_quad_modes()[mode])
    mpc.set_reference(*get_reference_chunk(traj, u_traj, t_ref, 6.0, 10, 0.1))
    seen = []
    hook = mpc.solver.vde.register_forward_pre_hook(lambda m, a: seen.append(a))
    try:
        mpc.optimize(torch.as_tensor(traj[300], dtype=torch.float32, device=cuda))
    finally:
        hook.remove()
    args = seen[0]
    assert args[0].shape[:2] == ((10, 2) if mode == "ensemble" else (1, 11))
    dyn = mpc.solver.f
    _hold_to_plain(dyn, _new_functor_outputs(dyn, *args, cuda), args,
                   anchored=mode in ("residual_fn", "ensemble"))


def test_quad_mpc_gp_mode_makes_no_host_sync_but_the_watchdog(cuda):
    """A GP-mode solve but for the watchdog's fetch (the warm start's
    retraction, the midpoint cluster, the node-0 mean, the stage rows and
    the solve) runs with every host synchronisation an error: the fetch
    is the solve's one sync."""
    from ad_mpc_tpu_torch.control.mpc import QuadMPC
    from ad_mpc_tpu_torch.experiments.quad_trajectory_test import (
        get_reference_chunk, reference)

    traj, t_ref, u_traj = reference("loop", 8.0)
    mpc = QuadMPC(ensemble=quad_fleet.fitted_ensemble(), device=cuda)
    mpc.set_reference(*get_reference_chunk(traj, u_traj, t_ref, 3.0, 10, 0.1))
    x0 = torch.as_tensor(traj[300], dtype=torch.float32, device=cuda)
    mpc.optimize(x0)  # cold start, allocator warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mpc._warm_start(x0)
        params = mpc._stage_params(x0, None)
        res = mpc.solver.solve(x0, mpc._yref_x, mpc._yref_u, params, mpc.state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert params.shape == (10, 7) and isinstance(mpc._last_cluster, torch.Tensor)
    assert bool(torch.isfinite(res.us).all())


def test_quad_tracking_on_card(cuda):
    """40 ticks of the loop at 8 m/s under drag through the kernels, with
    the dual-state fitted GP: finite, on the track, and per tick one launch
    of each kernel (plus the cold start's N RK4 rollout steps)."""
    from ad_mpc_tpu_torch.experiments.quad_trajectory_test import run_tracking
    from ad_mpc_tpu_torch.sim.simulator import DisturbanceConfig

    res = run_tracking(disturbances=DisturbanceConfig(drag=True), max_steps=40,
                       ensemble=quad_fleet.fitted_ensemble(), device=cuda)
    assert res.rmse < 0.1 and res.n_resets == 0
    assert res.launches == {"vde": 40, "lq_ipm": 40, "rk4": 40 + 10}


def test_fleet_solver_reaches_the_oracle_on_card(cuda):
    """Queue C 1 through the kernels: the committed oracle instance through
    ``BatchedSQPSolver`` at the c2 settings (12 IPM iterations, one RTI
    iteration, float32, N=20, broadcast p): 30 RTI re-solves end within 1e-3
    of the oracle's u0."""
    import os

    from ad_mpc_tpu_torch.testing import fleet_oracle_distance

    path = os.path.join(os.path.dirname(__file__), "fixtures", "oracle_bike_n20.npz")
    d, launches = fleet_oracle_distance(path, cuda, backend="cuda")
    assert d < 1e-3, d
    assert launches == {"vde": 30, "lq_ipm": 30, "rk4": 30}


@pytest.mark.parametrize("B", [1, RAGGED_B])
def test_gp_routed_kernels_match_plain(cuda, B):
    """The routed GP bicycle (``GPRoutedDyn``) on the JAX package's test
    ensemble, the two clusters in one launch (B > 1), N=3 (blocks span many
    scenarios' p rows): the sweep and both modes of the RK4 map against
    their plain versions at 2e-5 (``tests/test_pallas_vde.py``'s); a
    relaunch repeats its bits."""
    from ad_mpc_tpu_torch.testing import routed_bicycle_inputs

    N = 3
    dyn, xs, us, ps = routed_bicycle_inputs(B, N, cuda)
    assert type(dyn).__name__ == "GPRoutedDynamics" and ps.shape[1] == dyn.p_dim == 73
    vde = make_vde(dyn, 0.05, N, 7, 2, dyn.p_dim, device=cuda)
    rk4 = make_rk4(dyn, 0.05, 7, 2, dyn.p_dim, device=cuda)
    got = (*vde(xs, us, ps), rk4.defect(xs, us, ps), rk4(xs[:, 0], us[:, 0], ps))
    want = (*vde_plain(dyn, 0.05, 1, xs, us, ps),
            discrete_step(dyn, 0.05, 1, xs[:, :-1], us, ps[:, None]) - xs[:, 1:],
            discrete_step(dyn, 0.05, 1, xs[:, 0], us[:, 0], ps))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=0)
    again = (*vde(xs, us, ps), rk4.defect(xs, us, ps), rk4(xs[:, 0], us[:, 0], ps))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _routed_quad(name):
    from ad_mpc_tpu_torch.learned.lane import param_residual_dynamics

    ens = (quad_fleet.fitted_ensemble() if name == "fitted"
           else quad_fleet.make_quad_gp_ensemble(n=16, clusters=2))
    return param_residual_dynamics(ens, QuadDynamics(), 0, quad_frame=True)


@pytest.mark.parametrize("name", ["two_clusters", "fitted"])
@pytest.mark.parametrize("B", [1, RAGGED_B, 1000])
def test_gp_quad_routed_kernels_match_plain(cuda, B, name):
    """The routed body-frame GP (``GPQuadRoutedDyn``): each scenario's p
    packed at its body velocity, on the synthetic two-cluster ensemble
    (both clusters in one launch) at 3e-5, on the fitted one-cluster model
    held to the float64 plain version with its float32 spread."""
    from ad_mpc_tpu_torch.experiments.routed_fleet import body_velocities

    dyn, p_dim, pack = _routed_quad(name)
    xs, us, _ = _quad_traj(B, 10, cuda, seed=17)
    xs[..., 7:10] *= 10.0 if name == "two_clusters" else 5.0
    ps = pack(body_velocities(xs[:, 0]))
    assert ps.shape == (B, p_dim)
    if name == "two_clusters" and B > 1:
        assert len(set(pack.clusters(body_velocities(xs[:, 0])).flatten().tolist())) == 2
    got = _new_functor_outputs(dyn, xs, us, ps, cuda)
    _hold_to_plain(dyn, got, (xs, us, ps), anchored=name == "fitted")
    again = _new_functor_outputs(dyn, xs, us, ps, cuda)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_gp_quad_routed_refuses_a_p_of_another_width(cuda):
    """The C entry checks p against the struct's points (base + 3 GPs)."""
    dyn, p_dim, _ = _routed_quad("two_clusters")
    B, N = 4, 10
    xs, us, _ = _quad_traj(B, N, cuda)
    A = torch.empty((B, N, 13, 13), device=cuda)
    Bm = torch.empty((B, N, 13, 4), device=cuda)
    c = torch.empty((B, N, 13), device=cuda)
    ps = torch.zeros((B, p_dim + 1), device=cuda)
    fn, _ = _entry(dyn)
    err = fn(xs.data_ptr(), us.data_ptr(), ps.data_ptr(), A.data_ptr(),
             Bm.data_ptr(), c.data_ptr(), B, N, 13, 4, p_dim + 1, 0.1, 1,
             dyn.cuda_params(), torch.cuda.current_stream(cuda).cuda_stream)
    assert err != 0


def test_routed_one_cluster_tick_matches_gp_quad_tick(cuda):
    """The fitted one-cluster model routed through p gives the c6-fitted
    tick through ``GPQuadDyn`` (the same means, in the same order): u0
    within 1e-5 after one tick at B=256, the sweeps' bits equal. The two
    functors' RK4 maps on the tick's states and inputs are each held to
    the float64 plain version with its float32 spread, and to each other
    within ``testing.RK4_PAIR_TOL``: the fitted model's terms of up to
    2,755 sum to means under 6, so the two maps' float32 rounding moves a
    step by up to about 7e-5, and later ticks start from states that
    differ by that much."""
    from ad_mpc_tpu_torch.experiments.routed_fleet import (
        body_velocities, build_routed_quad_fleet)
    from ad_mpc_tpu_torch.learned.lane import param_residual_dynamics
    from ad_mpc_tpu_torch.testing import RK4_PAIR_TOL, rk4_pair

    ens = quad_fleet.fitted_ensemble()
    tick_r, init_r, solver_r, _, _ = build_routed_quad_fleet(ens, device=cuda)
    tick, init, _, _ = quad_fleet.build_quad_fleet(device=cuda, ensemble=ens)
    carry_r, _ = tick_r(init_r(256))
    carry, _ = tick(init(256))
    d = float((carry_r[5].us[:, 0] - carry[5].us[:, 0]).abs().max())
    assert d <= 1e-5, d
    assert solver_r.vde.launches == 2 and solver_r.qp.launches == 2
    dyn, p_dim, pack = param_residual_dynamics(ens, QuadDynamics(), 0, quad_frame=True)
    x, u = carry[0], carry[5].us[:, 0]
    diff, err_r, err_b, spread, held = rk4_pair(
        dyn, pack(body_velocities(x)), GPQuadDynamics(ens), x.new_zeros((256, 0)), x, u, 0.1)
    assert held and diff <= RK4_PAIR_TOL, (diff, err_r, err_b, spread)
    xs, us, _ = _quad_traj(64, 10, cuda)
    ps = pack(body_velocities(xs[:, 0]))
    got = make_vde(dyn, 0.1, 10, 13, 4, p_dim, device=cuda)(xs, us, ps)
    want = make_vde(GPQuadDynamics(ens), 0.1, 10, 13, 4, 0, device=cuda)(
        xs, us, torch.zeros((64, 0), device=cuda))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_mission_launches_and_host_syncs_on_card(cuda):
    """QuadMissionNode on the card, 12 hover messages (6 optimized): per
    solve one VDE, one LQ and one RK4 launch (the cold start adds the
    N=10 rollout), and per optimized message two fetches: the node's one
    copy of u0 and the predicted states, and QuadMPC's watchdog."""
    from ad_mpc_tpu_torch.nodes.quad_node import QuadMissionNode
    from ad_mpc_tpu_torch.testing import mission_host_syncs

    node = QuadMissionNode(device=cuda)
    fetch, watchdog, rest, n = mission_host_syncs(node, 12)
    s = node.mpc.solver
    assert n == 6 and fetch == n and watchdog == n, (fetch, watchdog, rest)
    assert (s.vde.launches, s.qp.launches, s.rk4.launches) == (6, 6, 16)
    assert node.last_xs.shape == (11, 13) and np.isfinite(node.last_xs).all()


def test_one_rank_nccl_fleet_has_the_single_process_bits(cuda, tmp_path):
    """``multihost --procs 1`` through an nccl group at c2's N=30 and a
    batch of 1024: the rank's u0, shifted warm start and plant step equal
    the single-process tick's bit for bit; 2 timed ticks plus the first."""
    from ad_mpc_tpu_torch.parallel.multihost import launch, parse_line
    from ad_mpc_tpu_torch.testing import c2_tick_reference

    ref = c2_tick_reference(1024, cuda)
    f = parse_line(launch(procs=1, batch=1024, nodes=30, qp_iters=12, ticks=2,
                          device="cuda", scenario="c2", dump=str(tmp_path), timeout=300))
    got = np.load(tmp_path / "rank0.npz")
    assert f["backend"] == "nccl" and f["launches"] == "vde:3,lq_ipm:3,rk4:4"
    for k in ("u0", "next_xs", "next_us", "x_next"):
        assert np.array_equal(got[k], ref[k]), k
    assert abs(float(f["kkt0"]) - ref["kkt_mean"]) <= 1e-6 * ref["kkt_mean"]


@pytest.mark.parametrize("delay", [0, 1])
def test_result_delay_sets_the_age_on_card(cuda, delay):
    """The pipelined AD node on the card: a result is back within its
    20 ms tick, published one tick after its solve; held one tick more
    with ``result_delay_ticks=1`` (the JAX rows' age of 2)."""
    import time

    from ad_mpc_tpu_torch.nodes.ad_node import ADControllerNode

    node = ADControllerNode(n_nodes=20, pipelined=True, result_delay_ticks=delay,
                            state_port=48760, control_port=48761,
                            waypoint_port=48762, status_port=48763, device=cuda)
    try:
        node.warmup()
        n = 80
        node.ref_gen.set_traj(np.linspace(0.0, 80.0, n), np.zeros(n), np.zeros(n),
                              np.full(n, 8.0))
        x = np.zeros(7)
        x[3] = 8.0
        for _ in range(20):
            node.control_tick(x)
            time.sleep(0.02)
    finally:
        node.close()
    assert np.percentile(node.result_age, 50) == 1 + delay
    assert min(node.result_age) == 1 + delay
