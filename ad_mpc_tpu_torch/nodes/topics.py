"""Topic map for the multi-process control stack (a copy of the JAX package's
``nodes/topics.py``).

Mirrors the reference's topic wiring (``gp_ad_mpc_node.py:115-143``):
state in, waypoints in, control out, status/markers out — with UDP ports
playing the role of topic names.
"""

STATE_PORT = 47101        # plant -> controller: 7D vehicle state
CONTROL_PORT = 47102      # controller -> plant: [accel, steer_rate, steer]
WAYPOINT_PORT = 47103     # reference gen -> controller: (M, 4) x/y/psi/v rows
STATUS_PORT = 47104       # controller heartbeat (is_mpc_busy analogue)
VIZ_PORT = 47105          # predicted/reference trajectory markers

REFERENCE_PORT = 47106    # quad reference gen -> controller (ReferenceTrajectory)
BUSY_PORT = 47107         # quad controller busy flag -> reference gen
QUAD_STATE_PORT = 47108   # quad plant -> controller: [seq, t, 13D state]
QUAD_CONTROL_PORT = 47109 # controller -> plant: encoded ControlCommand

TAG_STATE = 1
TAG_CONTROL = 2
TAG_WAYPOINTS = 3
TAG_STATUS = 4
TAG_PRED_TRAJ = 5
TAG_REF_TRAJ = 6
TAG_REFERENCE = 7
TAG_QUAD_STATE = 8
TAG_QUAD_CONTROL = 9
TAG_BUSY = 10
