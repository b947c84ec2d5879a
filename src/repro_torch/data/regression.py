"""Synthetic regression data for the port (``repro.data.regression`` counterpart).

Drawn with a ``torch.Generator`` seeded on the requested device, so a problem of
FIG3A's size is made on the card in one call. The draws differ from the JAX
reference's (different generators); tests hand both packages the same numpy data.
"""
from __future__ import annotations

import torch

from repro_torch.utils.device import resolve_device


def gaussian_regression(
    seed: int, n: int, d: int, *, noise: float = 0.1, planted: bool = True, device=None
):
    """A ~ N(0,1)^{n×d}; b = A x + noise·ε for a planted x ~ N(0, I) (else b ~ N(0, I)).

    Returns ``(A, b, {"x_truth": x or None})``, float32 on ``device`` (default CUDA).
    """
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((n, d), generator=g, device=dev)
    if planted:
        x = torch.randn((d,), generator=g, device=dev)
        b = A @ x + noise * torch.randn((n,), generator=g, device=dev)
    else:
        x = None
        b = torch.randn((n,), generator=g, device=dev)
    return A, b, {"x_truth": x}
