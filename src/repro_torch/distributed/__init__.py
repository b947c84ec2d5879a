"""Fault tolerance of the PyTorch port (``StragglerPolicy``, ``HeartbeatMonitor``)."""
