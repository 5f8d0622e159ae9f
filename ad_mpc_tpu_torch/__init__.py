"""PyTorch/CUDA port of :mod:`ad_mpc_tpu` for NVIDIA Hopper (H100).

The port runs the batched SQP-RTI fleet control tick (bench config c2:
dynamic bicycle, N=30, nx=7, nu=2) through two CUDA C++ kernels written by
hand for ``sm_90a``:

- ``csrc/vde.cu``: the fused RK4 + forward-sensitivity sweep
  (replaces ``ad_mpc_tpu/ops/pallas_vde.py:_vde_kernel``);
- ``csrc/lq_ipm.cu``: the fused fixed-iteration interior-point QP with its
  Riccati recursion (replaces ``ad_mpc_tpu/ops/pallas_lq.py:_lq_kernel_rolled``
  and the stage-unrolled ``_lq_kernel``).

Ground rules:

- The JAX package ``ad_mpc_tpu`` is the unchanged reference. Parity tests
  (``tests/test_torch_*.py``) hand the same numpy inputs to both packages.
- No JAX here: this package imports ``torch`` and numpy, never ``jax`` and
  nothing of ``ad_mpc_tpu`` (it keeps its own copies of the numpy-only
  modules it needs).
- The card by default: every entry point (``BatchedSQPSolver``,
  ``fleet.build_fleet``, ``make_vde``, ``make_lq_solver``) takes
  ``device="cuda"``; the tests pass ``device="cpu"``.
- No fallbacks: a kernel wrapper launches its kernel for a CUDA tensor or
  raises. It runs the plain PyTorch version only for a CPU tensor. The
  tensor's device decides; there is no backend knob.
- Models and the solver are ``nn.Module``s with weights and bounds as
  buffers; everything else is plain functions on tensors.
"""
