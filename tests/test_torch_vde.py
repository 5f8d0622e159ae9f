"""Port parity: the fused linearization sweep (kernel 1's plain version)
and the tangent-free RK4 map.

The port's ``make_vde(..., device="cpu")`` and ``make_rk4(...,
device="cpu")`` run the plain PyTorch versions that ``csrc/vde.cuh`` is held
against on the card. Here they are held against the JAX package's Pallas
kernel (interpret mode), its vmapped ``integrators.linearize`` and its
``discretize`` map, at the tolerance of ``tests/test_pallas_vde.py``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ad_mpc_tpu.models.bicycle import BicycleParams, bicycle_dynamics
from ad_mpc_tpu.ops.integrators import discretize, linearize, rollout
from ad_mpc_tpu.ops.pallas_vde import make_vde as jax_make_vde
from ad_mpc_tpu_torch.fleet import make_gp_bicycle
from ad_mpc_tpu_torch.models.bicycle import BicycleDynamics
from ad_mpc_tpu_torch.ops import _build, integrators
from ad_mpc_tpu_torch.ops.cuda_vde import make_rk4, make_vde
from ad_mpc_tpu_torch.testing import random_traj

_BP = BicycleParams()
DT = 0.05


def _jax_bicycle(x, u, p):
    return bicycle_dynamics(x, u, _BP, switch=p[0])


def _jax_xla_linearize(xs, us, ps):
    F = lambda p: discretize(lambda xx, uu: _jax_bicycle(xx, uu, p), DT, 1)
    return jax.vmap(lambda a, b, p: linearize(F(p), a, b))(xs, us, ps)


@pytest.mark.parametrize("switch", [1.0, 0.3], ids=["dynamic", "blend"])
def test_vde_matches_jax(switch):
    B, N = 5, 6  # B=5 with block_b=8: a ragged batch on the JAX side
    xs, us = random_traj(np.random.default_rng(3), B, N, 7, 2)
    ps = np.full((B, 1), switch, np.float32)

    lin = make_vde(BicycleDynamics(), DT, N, 7, 2, 1, device="cpu")
    A, Bm, c = lin(*(torch.as_tensor(a) for a in (xs, us, ps)))
    assert A.shape == (B, N, 7, 7) and Bm.shape == (B, N, 7, 2)
    assert c.shape == (B, N, 7) and A.dtype == torch.float32
    assert lin.launches == 0  # the plain version is not a kernel launch

    pallas = jax_make_vde(_jax_bicycle, DT, N, 7, 2, 1, block_b=8,
                          interpret=True)
    args = [jnp.asarray(a) for a in (xs, us, ps)]
    for ref in (pallas(*args), _jax_xla_linearize(*args)):
        for got, want in zip((A, Bm, c), ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=2e-5)


@pytest.mark.parametrize("switch", [1.0, 0.3], ids=["dynamic", "blend"])
def test_rk4_defect_matches_jax(switch):
    """The tangent-free map's defect is the sweep's c."""
    B, N = 5, 6
    xs, us = random_traj(np.random.default_rng(3), B, N, 7, 2)
    ps = np.full((B, 1), switch, np.float32)

    rk4 = make_rk4(BicycleDynamics(), DT, 7, 2, 1, device="cpu")
    got = rk4.defect(*(torch.as_tensor(a) for a in (xs, us, ps)))
    assert got.shape == (B, N, 7) and got.dtype == torch.float32
    assert rk4.launches == 0

    pallas = jax_make_vde(_jax_bicycle, DT, N, 7, 2, 1, block_b=8,
                          interpret=True)
    args = [jnp.asarray(a) for a in (xs, us, ps)]
    for ref in (pallas(*args), _jax_xla_linearize(*args)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref[2]), atol=2e-5)


@pytest.mark.parametrize("switch", [1.0, 0.3], ids=["dynamic", "blend"])
def test_rk4_step_matches_jax(switch):
    """One step per scenario, u taken from a strided view (``us[:, 1]``)."""
    M, N = 9, 4
    xs, us = random_traj(np.random.default_rng(6), M, N, 7, 2)
    ps = np.full((M, 1), switch, np.float32)

    rk4 = make_rk4(BicycleDynamics(), DT, 7, 2, 1, device="cpu")
    got = rk4(torch.as_tensor(xs[:, 0]), torch.as_tensor(us)[:, 1],
              torch.as_tensor(ps))
    assert got.shape == (M, 7) and rk4.launches == 0

    step = jax.vmap(lambda x, u, p: discretize(
        lambda xx, uu: _jax_bicycle(xx, uu, p), DT, 1)(x, u))
    want = step(jnp.asarray(xs[:, 0]), jnp.asarray(us[:, 1]), jnp.asarray(ps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("make", [
    lambda f: make_vde(f, DT, 4, 7, 2, 1, device="cuda"),
    lambda f: make_rk4(f, DT, 7, 2, 1, device="cuda"),
], ids=["vde", "rk4"])
def test_cuda_needs_a_functor(make):
    """A dynamics with no CUDA functor is refused for the card up front."""
    with pytest.raises(NotImplementedError):
        make(lambda x, u, p: x)


def test_build_hashes_headers(tmp_path, monkeypatch):
    """A kernel library's name changes when its source or a header under
    ``csrc/`` does, so an edited header never reuses a stale build."""
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._target("vde_bicycle")
    assert _build._target("vde_bicycle") == before
    header = tmp_path / "ieee_div.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build._target("vde_bicycle")
    assert after != before
    (tmp_path / "vde_bicycle.cu").write_text(
        (tmp_path / "vde_bicycle.cu").read_text() + "\n")
    assert _build._target("vde_bicycle") not in (before, after)


def test_bicycle_functor_params():
    """The bicycle names its C entries, and the struct it passes by value has
    the fields of ``BicycleParamsC`` in ``csrc/vde_models.cuh``, in that
    order."""
    csrc = Path(__file__).resolve().parents[1] / "ad_mpc_tpu_torch" / "csrc"
    src = "\n".join(p.read_text() for p in sorted(csrc.glob("vde*")))
    assert re.search(r"\bVDE_ENTRIES\(bicycle, BicycleDyn, BicycleParamsC\)", src)
    assert re.search(r"\bint vde_##model\(", src)
    assert re.search(r"\bint rk4_##model\(", src)
    c_fields = re.search(r"struct BicycleParamsC \{.*?float ([^;]+);", src,
                         re.S)
    names = [n.strip() for n in c_fields.group(1).split(",")]
    f = BicycleDynamics()
    assert f.cuda_entry == "vde_bicycle" and f.cuda_rk4_entry == "rk4_bicycle"
    assert (f.nx, f.nu, f.p_dim) == (7, 2, 1)
    params = f.cuda_params()
    assert [n for n, _ in params._fields_] == names
    want = [_BP.mass, _BP.l_f, _BP.l_r, _BP.iz, _BP.cf, _BP.cr,
            _BP.l_f + _BP.l_r]
    np.testing.assert_allclose([getattr(params, n) for n in names], want,
                               rtol=1e-7)


PTXAS = """ptxas info    : Compiling entry function '_Z10vde_kernelI12GPBicycleDynEvPKfS2_S2_PfS3_S3_iii5StepsT_' for 'sm_90a'
ptxas info    : Used 168 registers, used 0 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z10vde_kernelI10BicycleDynEvPKfS2_S2_PfS3_S3_iii5StepsT_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers
ptxas info    : Compiling entry function '_Z10rk4_kernelI12GPBicycleDynEvPKfxS2_xxS2_xPfiiii5StepsT_' for 'sm_90a'
    16 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers"""


def test_functor_resources_match_the_whole_name(monkeypatch):
    """A kernel's registers are found by its functor's exact name, as a
    whole template argument: ``BicycleDyn`` is not ``GPBicycleDyn``."""
    monkeypatch.setattr(_build, "ptxas_report", lambda name, defines=(): PTXAS)
    assert _build.functor_resources("vde", "vde_kernel", "BicycleDyn") == {
        "registers": 255, "spill_stores": 0, "spill_loads": 0}
    assert _build.functor_resources("vde", "vde_kernel", "GPBicycleDyn")[
        "registers"] == 168
    assert _build.functor_resources("vde", "rk4_kernel", "GPBicycleDyn") == {
        "registers": 40, "spill_stores": 12, "spill_loads": 16}
    with pytest.raises(RuntimeError):
        _build.functor_resources("vde", "rk4_kernel", "BicycleDyn")
    for f in (BicycleDynamics(), make_gp_bicycle(4)):
        tag = f"I{len(f.cuda_functor)}{f.cuda_functor}E"
        assert sum(tag in line for line in PTXAS.splitlines()) >= 1


def test_rollout_matches_jax():
    xs, us = random_traj(np.random.default_rng(4), 1, 8, 7, 2)
    F_j = discretize(lambda x, u: _jax_bicycle(x, u, jnp.ones(1, jnp.float32)), DT, 2)
    want = rollout(F_j, jnp.asarray(xs[0, 0]), jnp.asarray(us[0]))
    F = integrators.discretize(
        lambda x, u: BicycleDynamics()(x, u, torch.ones(1)), DT, 2)
    got = integrators.rollout(F, torch.as_tensor(xs[0, 0]),
                              torch.as_tensor(us[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


def test_opcount_counts_the_forward_mode_operations():
    """``experiments.opcount`` counts per element: a product of two state
    entries 1 primal and 3 per tangent, a transcendental 1 and 1, a repeated
    call once, operations on the parameters alone nothing; an operation it
    has no cost for raises."""
    from ad_mpc_tpu_torch.experiments.opcount import Counts, dyn_counts

    def f(x, u, p):
        s = torch.sin(x[2])
        return torch.stack([x[0] * x[1] + s, torch.sin(x[2]) * (p[0] * 2.0),
                            u[0] / x[3], x[1]])

    # mul (1, 3), sin (1, 1), add (1, 1), mul by p (1, 1), div (1, 3).
    assert dyn_counts(f, 4, 1, torch.ones(1)) == Counts(5, 9)
    with pytest.raises(NotImplementedError):
        dyn_counts(lambda x, u, p: torch.tanh(x), 4, 1, torch.ones(1))
