"""Quadrotor reference trajectories (numpy; the port's copy of
``ad_mpc_tpu/trajectories``)."""

from ad_mpc_tpu_torch.trajectories.keyframes import random_periodical_keyframes
from ad_mpc_tpu_torch.trajectories.polynomial import (
    fit_multi_segment_polynomial,
    sample_polynomial_trajectory,
)
from ad_mpc_tpu_torch.trajectories.quad_refs import (
    check_trajectory,
    lemniscate_trajectory,
    loop_trajectory,
    minimum_snap_trajectory,
    random_trajectory,
    straight_trajectory,
)

__all__ = [
    "check_trajectory",
    "fit_multi_segment_polynomial",
    "lemniscate_trajectory",
    "loop_trajectory",
    "minimum_snap_trajectory",
    "random_periodical_keyframes",
    "random_trajectory",
    "sample_polynomial_trajectory",
    "straight_trajectory",
]
