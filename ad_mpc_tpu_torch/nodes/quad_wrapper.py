"""Quadrotor deployment wrapper: physical parameters from a robot
description, and the body-rate ControlCommand (port of
``ad_mpc_tpu/nodes/quad_wrapper.py``, numpy only).

- :func:`parse_xacro_file` / :func:`quad_params_from_xacro`: read the robot
  description xacro (mass, rotor mass, inertia, arm length, rotor constants)
  and derive the plant parameters, with the '+' rotor layout for the
  hummingbird and 'x' for any other platform (``create_ros_gp_mpc.py:24-55``,
  ``utils/utils.py:746-770``);
- :class:`ControlCommand` and :func:`to_control_command`: an MPC solution as
  the body-rate command (control_mode=2): collective mass-normalized thrust
  from the first input, body rates from the second predicted state,
  per-rotor thrusts (``create_ros_gp_mpc.py:121-143``);
- a flat float64 codec for the UDP bridge (the quadrotor_msgs/ControlCommand
  role).
"""

from __future__ import annotations

import xml.etree.ElementTree as XMLtree
from typing import NamedTuple

import numpy as np

from ad_mpc_tpu_torch.models.quadrotor import QuadrotorParams


def parse_xacro_file(path: str) -> dict:
    """Flatten a robot-description xacro into an attribute dict: a node with
    a ``value`` attribute maps name -> value; a named node with children
    maps name -> the list of its children's attribute dicts."""
    tree = XMLtree.parse(path)
    attrib_dict = {}
    for node in tree.getroot():
        attributes = node.attrib
        if "value" in attributes:
            attrib_dict[attributes["name"]] = attributes["value"]
        children = list(node)
        if children and "name" in attributes:
            attrib_dict[attributes["name"]] = [c.attrib for c in children]
    return attrib_dict


def quad_params_from_xacro(path: str, quad_name: str = "") -> QuadrotorParams:
    """:class:`QuadrotorParams` of a xacro robot description: the total mass
    includes the 4 rotors, the max thrust is the max rotor speed squared
    times the motor constant, and the rotor layout is '+' for the
    hummingbird, 'x' otherwise."""
    a = parse_xacro_file(path)
    mass = float(a["mass"]) + 4.0 * float(a.get("mass_rotor", 0.0))
    inertia = a["body_inertia"][0]
    j = (float(inertia["ixx"]), float(inertia["iyy"]), float(inertia["izz"]))
    return QuadrotorParams(
        mass=mass,
        j=j,
        max_thrust=float(a["max_rot_velocity"]) ** 2 * float(a["motor_constant"]),
        length=float(a["arm_length"]),
        c_torque=float(a["moment_constant"]),
        configuration="+" if quad_name == "hummingbird" else "x",
    )


class ControlCommand(NamedTuple):
    """Body-rate control command (quadrotor_msgs/ControlCommand semantics,
    control_mode=2)."""

    t: float
    control_mode: int
    armed: bool
    collective_thrust: float  # mass-normalized [m/s^2]
    bodyrates: np.ndarray  # (3,) [rad/s]
    rotor_thrusts: np.ndarray  # (4,) [N]


def to_control_command(us, xs, params: QuadrotorParams, t: float = 0.0,
                       armed: bool = True,
                       thrust_offset: float = 0.0) -> ControlCommand:
    """An MPC solution as a body-rate command: the collective thrust is the
    sum of the first stage's normalized inputs times max_thrust / mass; the
    body rates are the SECOND predicted state's (the state reached when the
    command takes effect); the rotor thrusts are the inputs denormalized.
    ``us``, ``xs`` are host arrays. ``thrust_offset`` is the per-platform
    calibration hook (the colibri's -1.8 m/s^2)."""
    us = np.asarray(us)
    xs = np.asarray(xs)
    u0 = us[0] if us.ndim == 2 else us[:4]
    collective = float(np.sum(u0) * params.max_thrust / params.mass)
    return ControlCommand(
        t=float(t),
        control_mode=2,
        armed=bool(armed),
        collective_thrust=collective + thrust_offset,
        bodyrates=np.asarray(xs[1, 10:13], dtype=np.float64),
        rotor_thrusts=np.asarray(u0, dtype=np.float64) * params.max_thrust,
    )


def encode_control_command(cmd: ControlCommand) -> np.ndarray:
    """The bridge's message: [t, mode, armed, coll, wx, wy, wz, f1..f4]."""
    return np.concatenate([
        [cmd.t, float(cmd.control_mode), float(cmd.armed), cmd.collective_thrust],
        np.asarray(cmd.bodyrates, dtype=np.float64),
        np.asarray(cmd.rotor_thrusts, dtype=np.float64),
    ])


def decode_control_command(msg: np.ndarray) -> ControlCommand:
    m = np.asarray(msg, dtype=np.float64).ravel()
    return ControlCommand(t=float(m[0]), control_mode=int(m[1]), armed=bool(m[2]),
                          collective_thrust=float(m[3]), bodyrates=m[4:7],
                          rotor_thrusts=m[7:11])
