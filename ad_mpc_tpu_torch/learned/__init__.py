"""Learned residual dynamics: the GP layer of the port (see ``gp``,
``ensemble`` and ``lane``)."""
