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
from ad_mpc_tpu_torch.experiments.c2_kernels import c3_c4_bits, c5_bits, digest
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
