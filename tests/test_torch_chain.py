"""Port parity for the lane-layout chained product (the plain version of
``csrc/lane_chain.cu``), the MXU micro's pieces and the port's bench
accounting.

The reference kernel is not importable: ``ad_mpc_tpu/experiments/
mxu_riccati.py:135-163`` nests ``kernel`` and ``lane_chain_build`` inside
``micro()``, and the JAX package stays unchanged. :func:`_pallas_lane_chain`
is therefore a verbatim copy of those lines, run through
``pl.pallas_call(..., interpret=True)`` on the CPU as ``micro()`` itself
runs it off a TPU.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import bench
from ad_mpc_tpu.experiments.mxu_riccati import _renorm as jax_renorm
from ad_mpc_tpu_torch import bench as port_bench
from ad_mpc_tpu_torch.experiments import mxu_riccati, tf32
from ad_mpc_tpu_torch.ops import cuda_chain
from ad_mpc_tpu_torch.ops.cuda_chain import (
    LaneChain, chain_geometry, from_lanes, lane_chain_plain, make_lane_chain,
    to_lanes)

B, NX, CHAIN = 512, 7, 12


def _pallas_lane_chain(A, X, batch, nx, chain, block=512):
    """``mxu_riccati.py:135-163``, copied verbatim (interpret mode)."""
    def kernel(a_ref, x_ref, o_ref, *, nx, chain):
        a = a_ref[...]
        x = x_ref[...]
        for _ in range(chain):
            rows = []
            for i in range(nx):
                for k in range(nx):
                    acc = a[i * nx] * x[k]
                    for j in range(1, nx):
                        acc += a[i * nx + j] * x[j * nx + k]
                    rows.append(acc)
            x = jnp.stack(rows)
        o_ref[...] = x

    def lane_chain_build(A, X, block=512):
        At = A.reshape(batch, nx * nx).T.reshape(nx * nx, batch)
        Xt = X.reshape(batch, nx * nx).T.reshape(nx * nx, batch)
        spec = lambda: pl.BlockSpec(
            (nx * nx, block), lambda i: (0, i), memory_space=pltpu.VMEM
        )
        out = pl.pallas_call(
            functools.partial(kernel, nx=nx, chain=chain),
            grid=(batch // block,),
            in_specs=[spec(), spec()],
            out_specs=spec(),
            out_shape=jax.ShapeDtypeStruct((nx * nx, batch), jnp.float32),
            interpret=True,
        )(At, Xt)
        return out.T.reshape(batch, nx, nx)

    return lane_chain_build(A, X, block)


def _einsum_chain(A, X, chain):
    """The JAX micro's XLA arm at ``precision="highest"`` (``:121-130``)."""
    for _ in range(chain):
        X = jnp.einsum("bij,bjk->bik", A, X, precision="highest")
    return X


@pytest.fixture(scope="module")
def chain_inputs():
    """float32 (B, nx, nx) inputs drawn as at ``mxu_riccati.py:115-118``."""
    A, X = mxu_riccati.inputs(B, NX, 0, "cpu")
    return A.numpy(), X.numpy()


@pytest.fixture(scope="module")
def reference(chain_inputs):
    A, X = (jnp.asarray(a) for a in chain_inputs)
    return (np.asarray(_pallas_lane_chain(A, X, B, NX, CHAIN)),
            np.asarray(_einsum_chain(A, X, CHAIN)))


def _close(got, want):
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("against", ["pallas_interpret", "einsum_highest"])
def test_plain_matches_reference(chain_inputs, reference, against):
    A, X = (torch.as_tensor(a) for a in chain_inputs)
    got = from_lanes(lane_chain_plain(to_lanes(A), to_lanes(X), CHAIN), NX)
    _close(got.numpy(), reference[0 if against == "pallas_interpret" else 1])


@pytest.mark.parametrize("layout", ["lanes", "batch_first"])
def test_wrapper_on_cpu_runs_plain(chain_inputs, reference, layout):
    lane = make_lane_chain(device="cpu")
    A, X = (torch.as_tensor(a) for a in chain_inputs)
    if layout == "lanes":
        got = from_lanes(lane(to_lanes(A), to_lanes(X)), NX)
    else:
        got = lane(A, X)
    assert got.shape == (B, NX, NX) and lane.launches == 0
    _close(got.numpy(), reference[0])


def test_bmm_arm_and_renorm_match_jax(chain_inputs, reference):
    A, X = (torch.as_tensor(a) for a in chain_inputs)
    with tf32(False):
        got = mxu_riccati.bmm_chain(A, X, CHAIN)
    _close(got.numpy(), reference[1])
    np.testing.assert_allclose(mxu_riccati._renorm(got).numpy(),
                               np.asarray(jax_renorm(jnp.asarray(reference[1]))),
                               rtol=1e-5, atol=1e-6)


def test_inputs_match_jax_draws():
    A, X = mxu_riccati.inputs(16, NX, 0, "cpu")
    rng = np.random.default_rng(0)
    A_j = 0.18 * rng.normal(0, 1, (16, NX, NX)).astype(np.float32)
    X_j = rng.normal(0, 1, (16, NX, NX)).astype(np.float32)
    np.testing.assert_array_equal(A.numpy(), A_j)
    np.testing.assert_array_equal(X.numpy(), X_j)


def test_tf32_flag_restored_after_an_error():
    before = torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(ZeroDivisionError):
        with tf32(not before):
            1 / 0
    assert torch.backends.cuda.matmul.allow_tf32 == before


def test_measurements_refuse_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA device"):
        mxu_riccati.micro(batch=8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        mxu_riccati.macro(batch=8, device="cpu")


def test_lane_chain_needs_its_instance_on_the_card():
    with pytest.raises(NotImplementedError):
        make_lane_chain(nx=4, chain=12, device="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_lane_chain(device="cuda")
    assert isinstance(make_lane_chain(nx=4, chain=3, device="cpu"), LaneChain)


@pytest.mark.parametrize("batch", [1, 31, 32, 33, 37, 1000, 16384])
def test_chain_geometry_covers_every_batch(batch):
    """One block per 32 scenarios: the blocks cover the batch, and only the
    last may be ragged (B < 32 is one ragged block)."""
    geo = chain_geometry(batch)
    assert geo.threads == 7 * 32 and geo.block_bytes == 0
    assert (geo.blocks - 1) * geo.scenarios < batch <= geo.blocks * geo.scenarios


def test_chain_geometry_matches_source():
    """``chain_geometry`` mirrors the constants and the grid of
    ``csrc/lane_chain.cu``."""
    src = (Path(cuda_chain.__file__).resolve().parents[1] / "csrc"
           / "lane_chain.cu").read_text()
    const = dict(re.findall(r"constexpr int (LC_\w+) = (\d+);", src))
    assert (int(const["LC_NX"]), int(const["LC_CHAIN"]), int(const["LC_LANES"])) == (
        cuda_chain.NX, cuda_chain.CHAIN, cuda_chain.LANES)
    assert "LC_THREADS = LC_NX * LC_LANES" in src
    assert "grid = (unsigned)((batch + LC_LANES - 1) / LC_LANES)" in src
    assert chain_geometry(16384).blocks == 512


@pytest.mark.parametrize("N,flops", [(30, 861_240), (40, 1_148_320)])
def test_analytic_flops_match_bench(N, flops):
    args = (N, 7, 2, 12, 1, 90)
    assert port_bench.analytic_flops_per_solve(*args) == flops
    assert bench.analytic_flops_per_solve(*args) == flops


def test_roofline_and_gates():
    detail = {"configs": {
        "c2_dynamic_bicycle_b1024": {"solves_per_s": 1e5, "kkt_mean": 1e-7,
                                     "kkt_max": 1e-6, "lat_err_mean_m": 0.1},
        "c2_dynamic_bicycle_N40_b1024": {"solves_per_s": 1e5, "kkt_mean": 1e-7,
                                         "kkt_max": 1e-4, "lat_err_mean_m": 0.1},
    }, "errors": {"latency": "RuntimeError: x"}, "rti_vs_converged_u0": 1e-5}
    port_bench.annotate_roofline(detail)
    rows = detail["configs"]
    assert rows["c2_dynamic_bicycle_b1024"]["flops_per_solve"] == 861_240
    assert rows["c2_dynamic_bicycle_N40_b1024"]["flops_per_solve"] == 1_148_320
    np.testing.assert_allclose(rows["c2_dynamic_bicycle_b1024"]["pct_fp32_peak"],
                               100 * 861_240 * 1e5 / 67e12)
    assert port_bench._gates_for("c2_dynamic_bicycle_N40_b1024") == bench._gates_for(
        "c2_dynamic_bicycle_N40_b1024")
    failures = port_bench.gate_failures(detail)
    assert len(failures) == 2
    assert failures[0].startswith("c2_dynamic_bicycle_N40_b1024.kkt_max")
    assert failures[1].startswith("latency raised")
