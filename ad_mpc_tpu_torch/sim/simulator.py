"""The AD plant simulator with its disturbance suite (port of
``ad_mpc_tpu/sim/simulator.py:32-39, 120-179``).

:class:`BicycleSim` is the plant role CARLA plays for the AD stack: RK4
sub-steps of ``sim_dt`` over each control period, the steering angle
clipped to its physical range, and braking that stops at standstill
instead of driving the car backwards. It runs on the host: the state is a
tensor on ``device`` (the CPU, as the deployment loop pins the plant), and
the sub-steps integrate :func:`bicycle_dynamics` on Python floats (float64),
since at one vehicle a tensor operation's overhead costs far more than its
arithmetic. The JAX package's explicit PRNG key becomes a
``torch.Generator``; the noisy modes draw from it.

``QuadrotorSim`` is not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ad_mpc_tpu_torch.models.bicycle import BicycleParams, bicycle_dynamics
from ad_mpc_tpu_torch.ops.integrators import rk4_step_floats


class DisturbanceConfig(NamedTuple):
    """Toggles of the reference's simulation disturbances."""

    noisy: bool = False  # gaussian force/torque noise
    drag: bool = False  # quadratic aero + linear rotor drag (quadrotor)
    payload: bool = False  # constant payload force (quadrotor)
    motor_noise: bool = False  # asymmetric motor voltage noise


class BicycleSim:
    """7-state bicycle plant. ``step(x, u, dt)`` integrates one control
    period of length dt under the command u = [accel, steer_rate] and
    returns the next state as a tensor of x's dtype on ``device``.

    ``seed`` seeds the simulator's own generator, used when ``step`` is
    given none.
    """

    def __init__(self, params: BicycleParams = BicycleParams(),
                 disturbances: DisturbanceConfig = DisturbanceConfig(),
                 sim_dt: float = 1e-3, seed: int = 0, device="cpu"):
        self.params = params
        self.dist = disturbances
        self.sim_dt = sim_dt
        self.device = torch.device(device)
        self.generator = torch.Generator(device="cpu")
        self.generator.manual_seed(seed)

    def step(self, x, u, dt: float, generator=None):
        p, d = self.params, self.dist
        gen = self.generator if generator is None else generator
        u = [float(v) for v in torch.as_tensor(u).flatten().tolist()]
        u = [min(max(u[0], p.acc_min), p.acc_max),
             min(max(u[1], p.steering_rate_min), p.steering_rate_max)]
        if d.motor_noise:
            z = torch.randn(2, generator=gen, dtype=torch.float64).tolist()
            u = [a + 0.02 * math.sqrt(abs(a)) * n for a, n in zip(u, z)]
        n_sub = max(int(round(dt / self.sim_dt)), 1)
        h = dt / n_sub
        w = (torch.randn(2, generator=gen, dtype=torch.float64) * 0.5 * h).tolist() \
            if d.noisy else [0.0, 0.0]

        def f(xx, uu):
            xd = bicycle_dynamics(xx, uu, p)
            xd[3] += w[0]
            xd[4] += w[1]
            return xd

        xx = [float(v) for v in torch.as_tensor(x).tolist()]
        for _ in range(n_sub):
            xx = rk4_step_floats(f, xx, u, h)
            # Keep steering within its physical range.
            xx[6] = min(max(xx[6], p.steering_min), p.steering_max)
            # Braking stops at standstill: a negative command is a brake
            # (CARLA's AckermannDrive), never a reverse gear; otherwise the
            # brake-fallback controller would reverse the plant and the
            # arming gate could never re-arm.
            if u[0] < 0.0:
                xx[3] = max(xx[3], 0.0)
        dtype = x.dtype if isinstance(x, torch.Tensor) else torch.float64
        return torch.tensor(xx, dtype=dtype, device=self.device)
