"""Plant simulators of the port (``sim/simulator.py``)."""
