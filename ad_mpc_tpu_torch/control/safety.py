"""Safety / plausibility machinery of the closed-loop controller (port of
``ad_mpc_tpu/control/safety.py``).

- ``is_valid_command``: solution-vs-reference plausibility gate;
- ``check_pred_traj``: predicted-trajectory health check;
- ``backup_control``: time-shifted previous solution fallback;
- ``ArmingGate``: N-consecutive-success watchdog before the controller may
  publish;
- ``brake_command``: auxiliary full-braking fallback controller.

The gates return boolean tensors on their inputs' device, so the fused
controller step composes them without a host round trip.
"""

from __future__ import annotations

import torch


def is_valid_command(x_opt, x_ref, mean_tol=3.0, var_tol=2.0, max_tol=4.0):
    """Plausibility gate: mean, variance and max of the per-stage XY
    distance between the predicted trajectory and the reference must be
    small. The final entry is left at zero distance, as the reference's
    gate leaves it."""
    d = torch.sqrt((x_ref[:-1, 0] - x_opt[:-1, 0]) ** 2
                   + (x_ref[:-1, 1] - x_opt[:-1, 1]) ** 2)
    d = torch.cat([d, d.new_zeros(1)])
    return ((torch.mean(d) < mean_tol) & (torch.var(d, correction=1) < var_tol)
            & (torch.max(d) < max_tol))


def check_pred_traj(x_opt, x_now, jump_tol=5.0):
    """Predicted-trajectory health: no wild jump between the current state
    and the start of the prediction, no non-finite values."""
    finite = torch.isfinite(x_opt).all()
    jump = torch.sqrt(torch.sum((x_opt[0, :2] - x_now[:2]) ** 2))
    return finite & (jump < jump_tol)


def backup_control(prev_us):
    """Time-shift the previous control plan by one stage, repeating the last
    entry (the reference's "backup ctrl")."""
    return torch.cat([prev_us[1:], prev_us[-1:]], dim=0)


def brake_command(steering_hold, accel=-1e5):
    """Hold steering, full braking: the auxiliary fallback controller.
    Returns ([accel, 0], steering_hold)."""
    return torch.tensor([accel, 0.0]), steering_hold


class ArmingGate:
    """The controller must report ``n_required`` consecutive healthy solves
    before its output is trusted; any failure resets the count."""

    def __init__(self, n_required: int = 10):
        self.n_required = n_required
        self.count = 0

    def update(self, ok: bool) -> bool:
        self.count = self.count + 1 if ok else 0
        return self.armed

    @property
    def armed(self) -> bool:
        return self.count >= self.n_required
