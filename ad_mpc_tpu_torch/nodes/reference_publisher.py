"""Reference-trajectory generator and publisher (port of
``ad_mpc_tpu/nodes/reference_publisher.py``, numpy only; the
``reference_publisher_node.py`` role).

:class:`ReferenceGenerator` makes dense quadrotor references in the modes
loop, lemniscate, random and hover, iterating seeds x target velocities.
:class:`ReferencePublisherNode` sends them over the native UDP bridge one at
a time with the busy-flag handshake of ``reference_publisher_node.py:23-167``,
in the flat layout of ``ReferenceTrajectory.msg`` (:func:`encode_reference`).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ad_mpc_tpu_torch.models.quadrotor import QuadrotorParams, hover_input
from ad_mpc_tpu_torch.nodes.topics import BUSY_PORT, REFERENCE_PORT, TAG_REFERENCE
from ad_mpc_tpu_torch.trajectories import (
    lemniscate_trajectory,
    loop_trajectory,
    random_trajectory,
)


class ReferenceGenerator:
    """Iterates the (seed, velocity) pairs of one mode, seeds outermost."""

    def __init__(self, mode: str = "loop", velocities=(8.0,), seeds=(0,),
                 quad: QuadrotorParams = QuadrotorParams(),
                 discretization_dt: float = 0.01):
        if mode not in ("loop", "lemniscate", "random", "hover"):
            raise ValueError(mode)
        self.mode = mode
        self.quad = quad
        self.dt = discretization_dt
        self._queue = [(s, v) for s in seeds for v in velocities]
        self._i = 0

    def __len__(self):
        return len(self._queue)

    def next_trajectory(self):
        """(traj (n,13), t_ref (n,), inputs (n,4)), or None when exhausted."""
        if self._i >= len(self._queue):
            return None
        seed, v = self._queue[self._i]
        self._i += 1
        if self.mode == "loop":
            return loop_trajectory(self.quad, discretization_dt=self.dt, v_max=v)
        if self.mode == "lemniscate":
            return lemniscate_trajectory(self.quad, discretization_dt=self.dt,
                                         v_max=v)
        if self.mode == "random":
            # Speed-based time allocation: a higher v flies faster.
            return random_trajectory(self.quad, discretization_dt=self.dt,
                                     seed=seed, speed=v)
        # hover: a 2 s constant point reference at z = 1.
        n = int(2.0 / self.dt)
        traj = np.zeros((n, 13))
        traj[:, 2] = 1.0
        traj[:, 3] = 1.0
        t_ref = np.arange(n) * self.dt
        inputs = np.tile(hover_input(self.quad), (n, 1))
        return traj, t_ref, inputs


def encode_reference(traj, t_ref, inputs) -> np.ndarray:
    """One float64 message [n, dt, traj.ravel, inputs.ravel] (the
    ``ReferenceTrajectory.msg`` layout)."""
    n = len(t_ref)
    dt = float(t_ref[1] - t_ref[0]) if n > 1 else 0.0
    return np.concatenate([[float(n), dt], np.asarray(traj, float).ravel(),
                           np.asarray(inputs, float).ravel()])


def decode_reference(msg: np.ndarray):
    n = int(msg[0])
    dt = float(msg[1])
    traj = msg[2:2 + 13 * n].reshape(n, 13)
    inputs = msg[2 + 13 * n:2 + 17 * n].reshape(n, 4)
    t_ref = np.arange(n) * dt
    return traj, t_ref, inputs


class ReferencePublisherNode:
    """Publishes one reference, waits until the controller reports not
    busy, publishes the next. ``publisher`` and ``busy_subscriber`` replace
    the bridge's UDP endpoints on the two ports when given (any objects
    with ``publish(tag, arr)`` and ``receive(timeout_ms)``)."""

    def __init__(self, generator: Optional[ReferenceGenerator] = None,
                 reference_port: int = REFERENCE_PORT, busy_port: int = BUSY_PORT,
                 publisher=None, busy_subscriber=None):
        from ad_mpc_tpu_torch.runtime import Publisher, Subscriber

        self.gen = generator if generator is not None else ReferenceGenerator()
        self.pub = publisher if publisher is not None else Publisher(reference_port)
        self.busy_sub = (busy_subscriber if busy_subscriber is not None
                         else Subscriber(busy_port))

    def run(self, poll_ms: int = 100, max_trajectories: int | None = None,
            timeout_s: float = 120.0) -> int:
        """Publish the references one at a time; returns how many were sent.

        Before each publish the busy subscriber is drained, so that a stale
        busy=False queued earlier cannot release the next reference at once;
        a busy=True must be seen before a busy=False counts; and each wait
        is bounded by ``timeout_s``, so that a dead controller cannot hold
        the publisher forever."""
        sent = 0
        while max_trajectories is None or sent < max_trajectories:
            nxt = self.gen.next_trajectory()
            if nxt is None:
                break
            while self.busy_sub.receive(timeout_ms=0) is not None:
                pass
            self.pub.publish(TAG_REFERENCE, encode_reference(*nxt))
            sent += 1
            saw_busy = False
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                msg = self.busy_sub.receive(timeout_ms=poll_ms)
                if msg is None:
                    continue
                busy = bool(np.asarray(msg[1]).ravel()[0])
                if busy:
                    saw_busy = True
                elif saw_busy:
                    break
        return sent

    def close(self):
        for end in (self.pub, self.busy_sub):
            if hasattr(end, "close"):
                end.close()
