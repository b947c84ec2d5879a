"""Synthetic regression data for the port (``repro.data.regression`` counterpart).

Each generator returns (A, b, meta); ``b`` may be (n,) or (n, k) (the EMNIST
one-hot targets). Drawn with a ``torch.Generator`` seeded on the requested
device, so a problem of FIG3A's size is made on the card in one call. The draws
differ from the JAX reference's (different generators); tests hand both
packages the same numpy data.
"""
from __future__ import annotations

import math

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


def student_t_regression(seed: int, n: int, d: int, *, df: float = 1.5, noise: float = 0.1, device=None):
    """Paper Fig. 3: A entries ~ student-t(df) (heavy-tailed, high row coherence),
    clipped to ±1e3 as in the reference; b = A x + noise·ε for a planted
    x ~ N(0, I). The t draw is z/√(χ²_df/df), χ²_df = 2·Gamma(df/2)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn((n, d), generator=g, device=dev)
    gam = torch._standard_gamma(torch.full((n, d), df / 2.0, device=dev), generator=g)
    A = torch.clamp(z * torch.rsqrt(gam * (2.0 / df)), -1e3, 1e3)
    del z, gam
    x = torch.randn((d,), generator=g, device=dev)
    b = A @ x + noise * torch.randn((n,), generator=g, device=dev)
    return A, b, {"x_truth": x}


def _median(v: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a vector: the middle value, or the mean of the two middle
    values for even length (``torch.median`` takes the lower one)."""
    s = torch.sort(v).values
    n = s.shape[0]
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2


def airline_like(seed: int, n: int, *, cards=(12, 31, 7, 24, 60), numeric: int = 2, noise: float = 0.3,
                 device=None):
    """Dummy-coded categorical design like the paper's airline matrix: a one-hot
    block per category cardinality in ``cards``, then ``numeric`` lognormal/5
    columns; d = sum(cards) + numeric. b is a planted linear score (x ~ N(0, I/d))
    plus noise, thresholded at its median to {0, 1} (the DepDelay>15 target).
    Each one-hot block sums to the ones vector, so A has rank
    d − len(cards) + 1 (132 of 136 by default), as the reference's does."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    blocks = []
    for c in cards:
        idx = torch.randint(0, c, (n,), generator=g, device=dev)
        blocks.append(torch.nn.functional.one_hot(idx, c).to(torch.float32))
    num = torch.exp(torch.randn((n, numeric), generator=g, device=dev)) / 5.0
    A = torch.cat(blocks + [num], dim=1)
    d = A.shape[1]
    x = torch.randn((d,), generator=g, device=dev) / math.sqrt(d)
    score = A @ x + noise * torch.randn((n,), generator=g, device=dev)
    b = (score > _median(score)).to(torch.float32)
    return A, b, {"x_truth": x, "d": d}


def emnist_like(seed: int, n: int, *, classes: int = 47, img_dim: int = 784, noise: float = 1.0, device=None):
    """Class-structured image-like data for the Fig. 2 experiment: rows are noisy
    class templates (N(0, 4) entries, template scales from 0.5 to 4 in
    geometric steps), labels Zipf-skewed (P(class c) ∝ 1/(1 + c)), b the one-hot
    label matrix (least squares as multiclass). Returns (A, B, {"labels"})."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    templates = torch.randn((classes, img_dim), generator=g, device=dev) * 2.0
    scale = torch.exp(torch.linspace(math.log(0.5), math.log(4.0), classes, device=dev))
    templates = templates * scale[:, None]
    probs = 1.0 / (1.0 + torch.arange(classes, dtype=torch.float32, device=dev))
    labels = torch.multinomial(probs / probs.sum(), n, replacement=True, generator=g)
    A = templates[labels] + noise * torch.randn((n, img_dim), generator=g, device=dev)
    B = torch.nn.functional.one_hot(labels, classes).to(torch.float32)
    return A, B, {"labels": labels}


def accuracy(A: torch.Tensor, B_onehot: torch.Tensor, X: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Multiclass accuracy of the least-squares classifier X (img_dim, classes):
    the share of rows whose largest score in A @ X (full float32) is its label."""
    from repro_torch.kernels import common

    with common.full_fp32_matmul():
        pred = torch.argmax(A @ X.to(A.dtype), dim=1)
    return torch.mean((pred == labels.to(pred.device)).to(torch.float32))
