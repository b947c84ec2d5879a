"""Device resolution for the port's entry points.

The entry points run on the CUDA device by default. They never drop to the CPU
on their own: a caller that wants the CPU (the tests) says ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device raises when CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port's entry points run on the GPU by default; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
