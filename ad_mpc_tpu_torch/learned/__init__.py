"""Learned residual dynamics: the GP layer of the port (``gp``,
``ensemble``, ``lane``) and its fitting pipeline (``cluster``, ``dataset``,
``rdrv``, ``fitting``)."""
