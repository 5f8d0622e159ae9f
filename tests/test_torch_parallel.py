"""Port parity for the fleet split over processes
(``ad_mpc_tpu/parallel/{mesh,batch,multihost}.py`` and
``__graft_entry__.py``): ``BatchedSolver.step`` and ``init_states`` against
the JAX package's at ``tests/test_batch_sharding.py``'s shapes (2e-5); the
rank layouts; a two-rank gloo run against the one-rank run (u0, the
shifted warm start and the plant step within 2e-5, the KKT mean to 1e-6
relative); a worker's failure raising in the launcher; ``nccl`` refused
without a GPU per rank; ``entry()`` and ``dryrun_multichip(4)`` on the CPU.
Each spawning test is bounded by 120 s.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from ad_mpc_tpu.control.mpc import bicycle_spec as jax_bicycle_spec
from ad_mpc_tpu.models.bicycle import BicycleParams, bicycle_dynamics
from ad_mpc_tpu.parallel.batch import BatchedSolver as JaxBatchedSolver
from ad_mpc_tpu_torch import entry
from ad_mpc_tpu_torch.control.mpc import bicycle_spec
from ad_mpc_tpu_torch.models.bicycle import BicycleDynamics
from ad_mpc_tpu_torch.parallel import mesh, multihost
from ad_mpc_tpu_torch.parallel.batch import BatchedSolver
from ad_mpc_tpu_torch.testing import one_thread  # noqa: F401

SPAWN_TIMEOUT = 120.0


def _jax_dyn():
    p = BicycleParams()
    return lambda x, u, pp: bicycle_dynamics(x, u, p, switch=pp[0])


@pytest.mark.parametrize("B, seed", [(4, 0), (16, 1)])
def test_batched_solver_matches_jax(B, seed):
    """``test_batch_sharding.py``'s shapes: N=8, 6 IPM iterations; three
    ticks from the constant-input rollout."""
    N = 8
    x0, yx, yu, p = multihost.straight_inputs(B, N, 0.05)
    rng = np.random.default_rng(seed)
    x0[:, 3] = rng.uniform(4, 10, B)
    yx[:, :, 0] = x0[:, 3:4] * (np.arange(N + 1) * 0.05)[None]
    yx[:, :, 3] = x0[:, 3:4]
    jsolver = JaxBatchedSolver(jax_bicycle_spec(t_horizon=0.4, n_nodes=N, qp_iters=6),
                               _jax_dyn(), p_dim=1, dtype=jnp.float32,
                               donate_state=False)
    solver = BatchedSolver(bicycle_spec(t_horizon=0.4, n_nodes=N, qp_iters=6),
                           BicycleDynamics(), p_dim=1, device="cpu")
    assert solver.backend == "plain" and solver.layout.world == 1
    u0 = rng.uniform(-0.5, 0.5, (B, 2)).astype(np.float32)
    jst = jsolver.init_states(jnp.asarray(x0), u0=jnp.asarray(u0))
    st = solver.init_states(x0, u0=u0)
    np.testing.assert_allclose(st.xs.numpy(), np.asarray(jst.xs), atol=2e-5, rtol=0)
    np.testing.assert_allclose(st.us.numpy(), np.asarray(jst.us), atol=0, rtol=0)
    jst, st = jsolver.init_states(jnp.asarray(x0)), solver.init_states(x0)
    args = [torch.as_tensor(a) for a in (x0, yx, yu, p)]
    for _ in range(3):
        jus, jxs, jst, jkkt = jsolver.step(*(jnp.asarray(a) for a in (x0, yx, yu, p)), jst)
        us, xs, st, kkt = solver.step(*args, st)
        for a, b in ((us, jus), (xs, jxs), (st.xs, jst.xs), (st.us, jst.us),
                     (kkt, jkkt)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=0)
    assert float(kkt.max()) < 1e-3  # the RTI contract after three ticks
    assert solver.kkt_mean(kkt) == pytest.approx(float(kkt.mean()), rel=1e-12)


def test_rank_layouts_are_host_major():
    one = mesh.make_layout(4)
    assert one.world == 4 and (one.n_hosts, one.per_host) == (1, 4)
    assert [mesh.shard_slice(16, r, one) for r in range(4)] == [
        slice(0, 4), slice(4, 8), slice(8, 12), slice(12, 16)]
    two = mesh.make_layout_2d(2, 3)
    assert two.world == 6 and (two.n_hosts, two.per_host) == (2, 3)
    assert [two.coords(r) for r in range(6)] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert mesh.shard_slice(12, 4, two) == slice(8, 10)
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_slice(10, 0, mesh.make_layout(4))
    assert 0 < mesh.free_port() < 65536


@pytest.mark.skipif(torch.cuda.device_count() >= 2, reason="this host has 2 GPUs")
def test_nccl_is_refused_without_a_gpu_per_rank():
    with pytest.raises(RuntimeError, match="'nccl' needs a GPU per rank"):
        mesh.init_group("nccl", 2, 0, mesh.free_port())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.rank_device("gloo", "cuda", 0)
    with pytest.raises(ValueError):
        mesh.init_group("mpi", 1, 0, mesh.free_port())
    assert mesh.rank_device("gloo", "cpu", 3) == torch.device("cpu")


def test_two_ranks_match_one_rank(tmp_path):
    lines, dumps = {}, {}
    for procs in (1, 2):
        lines[procs] = multihost.parse_line(multihost.launch(
            procs=procs, batch=16, ticks=2, device="cpu", dump=str(tmp_path / str(procs)),
            timeout=SPAWN_TIMEOUT))
        dumps[procs] = [np.load(tmp_path / str(procs) / f"rank{r}.npz")
                        for r in range(procs)]
    f = lines[2]
    # Two ranks on the one CPU: one device in use.
    assert (f["procs"], f["devices"], f["backend"], f["layout"]) == ("2", "1", "gloo", "1x2")
    assert len(f["per_rank_solves_per_s"].split(",")) == 2
    assert float(f["solves_per_s"]) > 0 and float(f["kkt"]) < 1e-3
    assert [tuple(d["rows"]) for d in dumps[2]] == [(0, 8), (8, 16)]
    one = dumps[1][0]
    for key in ("u0", "next_xs", "next_us", "x_next", "kkt"):
        two = np.concatenate([d[key] for d in dumps[2]])
        np.testing.assert_allclose(two, one[key], atol=2e-5, rtol=0)
    k1, k2 = float(lines[1]["kkt"]), float(lines[2]["kkt"])
    assert math.isclose(k1, k2, rel_tol=1e-6)


def test_a_failing_worker_fails_the_launch():
    # 15 scenarios do not split over 2 ranks: each worker raises.
    with pytest.raises(RuntimeError, match="multihost worker .* rc="):
        multihost.launch(procs=2, batch=15, device="cpu", timeout=SPAWN_TIMEOUT)


def test_entry_solves_as_the_jax_entry():
    fn, args = entry.entry(device="cpu")
    us, xs = fn(*args)
    jfn, jargs = jax_entry.entry()
    jus, jxs = jfn(*jargs)
    assert us.shape == (20, 2) and xs.shape == (21, 7)
    np.testing.assert_allclose(us.numpy(), np.asarray(jus), atol=1e-4, rtol=0)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), atol=1e-4, rtol=0)


def test_dryrun_multichip_four_processes():
    f = multihost.parse_line(entry.dryrun_multichip(4, timeout=SPAWN_TIMEOUT))
    assert (f["procs"], f["layout"], f["batch"], f["device"]) == ("4", "2x2", "8", "cpu")
    assert float(f["kkt"]) < 1e-3 and float(f["gp_kkt"]) < 1e-2
