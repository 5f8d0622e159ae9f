"""The deployment nodes of the port: the AD controller and the plant simulator over the native bridge."""
