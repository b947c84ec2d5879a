"""Serving substrate of the port: sketch-solve job admission (``SolveServer``)."""
from repro_torch.serve.engine import SolveJob, SolveServer

__all__ = ["SolveJob", "SolveServer"]
