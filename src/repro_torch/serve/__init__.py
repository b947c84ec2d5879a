"""Serving substrate of the port: the batched LM engine (``Engine``) and
sketch-solve job admission (``SolveServer``)."""
from repro_torch.serve.engine import Engine, ServeConfig, SolveJob, SolveServer, sample_token

__all__ = ["Engine", "ServeConfig", "SolveJob", "SolveServer", "sample_token"]
