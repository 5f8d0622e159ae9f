"""Random periodic 3D keyframe generation.

A copy of the JAX package's numpy module of the same name (the port
imports nothing of that package).

Capability parity with the reference's GP-prior keyframe sampler
(``ros_gp_mpc/src/utils/keyframe_3d_gen.py:61-166``:
``random_periodical_trajectory`` draws smooth periodic random functions via
an ExpSineSquared-kernel GP prior and rescales them to map limits).

Here the periodic random functions are drawn as a random Fourier series —
the spectral representation of the same stationary periodic prior — which
needs no sklearn and is trivially vectorized.
"""

from __future__ import annotations

import numpy as np


def random_periodical_keyframes(
    n_keyframes: int = 10,
    map_limits=((-5.0, 5.0), (-5.0, 5.0), (0.5, 3.0)),
    n_harmonics: int = 4,
    seed: int | None = None,
):
    """Draw one random smooth closed 3D curve and sample keyframes on it.

    :return: (keyframes (n_keyframes+1, 3) with the first point repeated at
        the end to close the loop, theta (n_keyframes+1,) curve parameter in
        [0, 2pi]).
    """
    rng = np.random.default_rng(seed)
    theta = np.linspace(0.0, 2.0 * np.pi, n_keyframes + 1)

    limits = np.asarray(map_limits, dtype=float)
    pts = np.zeros((n_keyframes + 1, 3))
    for ax in range(3):
        # Random Fourier series with 1/k amplitude decay (smooth draws).
        k = np.arange(1, n_harmonics + 1)
        a = rng.normal(size=n_harmonics) / k
        phi = rng.uniform(0, 2 * np.pi, n_harmonics)
        f = np.sum(
            a[None, :] * np.sin(k[None, :] * theta[:, None] + phi[None, :]),
            axis=1,
        )
        # Rescale the draw into the per-axis map limits
        # (keyframe_3d_gen.py map-limit scaling).
        lo, hi = limits[ax]
        fmin, fmax = f.min(), f.max()
        span = max(fmax - fmin, 1e-9)
        pts[:, ax] = lo + (f - fmin) / span * (hi - lo)

    pts[-1] = pts[0]
    return pts, theta
