"""The plant simulators with their disturbance suite (port of
``ad_mpc_tpu/sim/simulator.py``).

:class:`QuadrotorSim` is the 13-state quadrotor twin: RK4 sub-steps of
``sim_dt`` over each control period, with quadratic aero drag and linear
rotor drag in the body frame, a payload force, force and torque noise
drawn once per control period and held over its sub-steps, and motor
noise (bias ``0.1 (u/1.3)^2``, standard deviation ``0.02 sqrt(u)``); the
quaternion is renormalized after each sub-step.

:class:`BicycleSim` is the plant role CARLA plays for the AD stack: RK4
sub-steps of ``sim_dt`` over each control period, the steering angle
clipped to its physical range, and braking that stops at standstill
instead of driving the car backwards. It runs on the host: the state is a
tensor on ``device`` (the CPU, as the deployment loop pins the plant), and
the sub-steps integrate :func:`bicycle_dynamics` on Python floats (float64),
since at one vehicle a tensor operation's overhead costs far more than its
arithmetic. Both plants run so. The JAX package's explicit PRNG key
becomes a ``torch.Generator``; the noisy modes draw from it (other numbers
than the JAX package's for the same seed).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ad_mpc_tpu_torch.learned.lane import _rot_rows
from ad_mpc_tpu_torch.models.bicycle import BicycleParams, bicycle_dynamics
from ad_mpc_tpu_torch.models.quadrotor import QuadrotorParams
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


class QuadrotorSim:
    """13-state quadrotor plant. ``step(x, u, dt)`` integrates one control
    period of length dt under the normalized motor command u in [0, 1]^4
    (clipped) and returns the next state as a tensor of x's dtype on
    ``device``. The reference uses sub-steps of 0.5 ms.

    ``seed`` seeds the simulator's own generator, used when ``step`` is
    given none; each step draws, in this order and only for the modes that
    are on, 4 motor normals, 3 force normals and 3 torque normals.
    """

    ROTOR_DRAG = (0.3, 0.3, 0.0)  # linear rotor drag per body axis
    AERO_DRAG = 0.08  # quadratic aero drag coefficient
    PAYLOAD = 0.3  # payload mass [kg]

    def __init__(self, params: QuadrotorParams = QuadrotorParams(),
                 disturbances: DisturbanceConfig = DisturbanceConfig(),
                 sim_dt: float = 5e-4, seed: int = 0, device="cpu"):
        self.params = params
        self.dist = disturbances
        self.sim_dt = sim_dt
        self.device = torch.device(device)
        self.generator = torch.Generator(device="cpu")
        self.generator.manual_seed(seed)

    def _xdot(self, x, f, f_d, t_d):
        """The quad's x_dot under the motor thrusts f (N) plus the
        disturbance accelerations, on Python floats."""
        p, d = self.params, self.dist
        q, v, w = x[3:7], x[7:10], x[10:13]
        qw, qx, qy, qz = q
        wx, wy, wz = w
        jxx, jyy, jzz = (float(j) for j in p.j)
        R = _rot_rows(x)
        a = (f[0] + f[1] + f[2] + f[3]) / p.mass
        # Specific thrust along body z, then the extra accelerations in the
        # body frame: drag, the force noise; rotated to the world once.
        a_b = [0.0, 0.0, a]
        fd = [fi / p.mass for fi in f_d]
        if d.drag:
            v_b = [R[0][k] * v[0] + R[1][k] * v[1] + R[2][k] * v[2] for k in range(3)]
            a_b = [a_b[k] - self.AERO_DRAG * v_b[k] * abs(v_b[k]) / p.mass
                   - self.ROTOR_DRAG[k] * v_b[k] / p.mass for k in range(3)]
        a_b = [a_b[k] + fd[k] for k in range(3)]
        g_eff = p.g + (self.PAYLOAD * p.g / p.mass if d.payload else 0.0)
        v_dot = [R[r][0] * a_b[0] + R[r][1] * a_b[1] + R[r][2] * a_b[2]
                 for r in range(3)]
        v_dot[2] -= g_eff
        m_x = sum(fi * yi for fi, yi in zip(f, p.y_f))
        m_y = -sum(fi * xi for fi, xi in zip(f, p.x_f))
        m_z = sum(fi * zi for fi, zi in zip(f, p.z_l_tau))
        return [
            v[0], v[1], v[2],
            0.5 * (-qx * wx - qy * wy - qz * wz),
            0.5 * (qw * wx + qy * wz - qz * wy),
            0.5 * (qw * wy - qx * wz + qz * wx),
            0.5 * (qw * wz + qx * wy - qy * wx),
            v_dot[0], v_dot[1], v_dot[2],
            (m_x + (jyy - jzz) * wy * wz) / jxx + t_d[0] / jxx,
            (m_y + (jzz - jxx) * wz * wx) / jyy + t_d[1] / jyy,
            (m_z + (jxx - jyy) * wx * wy) / jzz + t_d[2] / jzz,
        ]

    def step(self, x, u, dt: float, generator=None):
        p, d = self.params, self.dist
        gen = self.generator if generator is None else generator
        normal = lambda n: torch.randn(n, generator=gen, dtype=torch.float64).tolist()
        u = [min(max(float(v), 0.0), 1.0)
             for v in torch.as_tensor(u).flatten().tolist()]
        if d.motor_noise:
            z = normal(4)
            u = [min(max(a - (0.1 * (a / 1.3) ** 2 + 0.02 * math.sqrt(a) * n),
                         0.0), 1.0) for a, n in zip(u, z)]
        f = [a * p.max_thrust for a in u]
        n_sub = max(int(round(dt / self.sim_dt)), 1)
        h = dt / n_sub
        f_d, t_d = ([10.0 * h * n for n in normal(3)], [10.0 * h * n for n in normal(3)]) \
            if d.noisy else ([0.0] * 3, [0.0] * 3)

        xx = [float(v) for v in torch.as_tensor(x).tolist()]
        for _ in range(n_sub):
            xx = rk4_step_floats(lambda s, _: self._xdot(s, f, f_d, t_d), xx, None, h)
            norm = math.sqrt(sum(c * c for c in xx[3:7]))
            xx[3:7] = [c / norm for c in xx[3:7]]
        dtype = x.dtype if isinstance(x, torch.Tensor) else torch.float64
        return torch.tensor(xx, dtype=dtype, device=self.device)
