"""PyTorch/CUDA port of :mod:`ad_mpc_tpu` for NVIDIA Hopper (H100).

The port runs the batched SQP-RTI fleet control tick (bench config c2:
dynamic bicycle, N=30 and the reference's N=40, nx=7, nu=2; c3: the
bicycle with a GP mean, ``learned/``; c4: the Pacejka friction/topography
sweep; c5: the quadrotor, nx=13, nu=4, N=10, two Gauss-Newton iterations,
``experiments/quad_fleet.py``; c6: the quadrotor with a body-frame GP
residual, the bench's synthetic ensemble or the fitted ``gp_flagship_c1``
model carried across in ``data/``), the bench's Riccati-algebra rows, the
single-vehicle AD path, ``QuadMPC`` and its tracking loop, and the learned
pipeline (record, fit, the flagship sweep; the parameter-routed GP fleet)
through three CUDA C++ kernels written by hand for ``sm_90a``:

- ``csrc/vde.cuh``: the fused RK4 + forward-sensitivity sweep, one functor
  per model in one source per family (``csrc/vde_<family>.cu``: bicycle,
  Pacejka, GP bicycle and its routed form, quadrotor and its RDRv drag, GP
  quadrotor, its routed form, the dual-state GP quadrotor) (replaces
  ``ad_mpc_tpu/ops/pallas_vde.py:_vde_kernel``);
- ``csrc/lq_ipm.cu``: the fused fixed-iteration interior-point QP with its
  Riccati recursion, at 7x2 and 13x4 (replaces
  ``ad_mpc_tpu/ops/pallas_lq.py:_lq_kernel_rolled`` and the stage-unrolled
  ``_lq_kernel``);
- ``csrc/lane_chain.cu``: the chained batched 7x7 product of the MXU
  micro (replaces ``ad_mpc_tpu/experiments/mxu_riccati.py:kernel``).

``bench.py`` runs the ported rows of the JAX package's bench; the
associative-scan Riccati is ``ops/assoc_riccati.py``.

Ground rules:

- The JAX package ``ad_mpc_tpu`` is the unchanged reference. Parity tests
  (``tests/test_torch_*.py``) hand the same numpy inputs to both packages.
- No JAX here: this package imports ``torch`` and numpy, never ``jax``,
  nothing of ``ad_mpc_tpu`` and not the root ``bench.py`` (it keeps its own
  copies of the numpy-only code it needs).
- The card by default: every entry point (``BatchedSQPSolver``,
  ``fleet.build_fleet``, ``make_vde``, ``make_lq_solver``,
  ``make_lane_chain``, the experiments) takes ``device="cuda"``; the tests
  pass ``device="cpu"``.
- No fallbacks: a kernel wrapper launches its kernel for a CUDA tensor or
  raises. It runs the plain PyTorch version only for a CPU tensor. The
  solver's ``backend`` (``"auto"``, ``"cuda"``, ``"plain"``) chooses the
  kernels or their plain versions; ``"auto"`` never picks the plain path on
  a CUDA device.
- Models and the solver are ``nn.Module``s with weights and bounds as
  buffers; everything else is plain functions on tensors.
"""
