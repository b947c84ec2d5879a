"""Sketch configuration (port of ``repro.core.sketches``).

``SketchSpec`` and ``KINDS`` are the reference's, field for field, so a spec
means the same thing to both packages. The port has operators for the dense
families ``gaussian`` and ``rademacher``, the randomized Hadamard ``srht`` and the
sparse ``sjlt``; building an operator of a sampling kind (``uniform``,
``leverage``, ``hybrid``) raises ``NotImplementedError`` naming the ROADMAP entry
that ports it (:func:`repro_torch.core.operators.make_operator`). The plain
Walsh-Hadamard transform the SRHT applies lives here, as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

KINDS = ("gaussian", "rademacher", "srht", "uniform", "leverage", "sjlt", "hybrid")


@dataclasses.dataclass(frozen=True)
class SketchSpec:
    """Static description of a sketching operator.

    Attributes:
      kind: one of ``KINDS``.
      m: sketch dimension (rows of S).
      replacement: (uniform/leverage) sample with replacement.
      s: (sjlt) nonzeros per column of S.
      m_prime: (hybrid) intermediate uniform-sampling dimension, m <= m_prime <= n.
      inner: (hybrid) kind of the second-stage sketch.
      use_kernel: route the fused sketch→Gram through the hand-written CUDA
        kernels (``repro_torch.kernels``); on CPU tensors their plain versions.
    """

    kind: str
    m: int
    replacement: bool = True
    s: int = 4
    m_prime: int = 0
    inner: str = "gaussian"
    use_kernel: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown sketch kind {self.kind!r}; expected one of {KINDS}")
        if self.m <= 0:
            raise ValueError("sketch dimension m must be positive")
        if self.kind == "hybrid":
            if self.m_prime < self.m:
                raise ValueError("hybrid sketch needs m_prime >= m")
            if self.inner not in ("gaussian", "rademacher", "sjlt", "srht"):
                raise ValueError(f"unsupported hybrid inner sketch {self.inner!r}")


def sketch_data(spec: SketchSpec, key: torch.Tensor, A: torch.Tensor, b: torch.Tensor):
    """Sketch (A, b) with the *same* S (Algorithm 1): returns (SA, Sb).

    b may be (n,) or (n, k)."""
    from repro_torch.core import operators

    bm = b if b.ndim == 2 else b[:, None]
    d = A.shape[1]
    SAb = operators.make_operator(spec, key, A.shape[0]).apply(torch.cat([A, bm.to(A.dtype)], dim=1))
    Sb = SAb[:, d:]
    return SAb[:, :d], (Sb if b.ndim == 2 else Sb[:, 0])


# ----------------------------------------------------------------- hadamard utils


def _fwht(x: torch.Tensor) -> torch.Tensor:
    """Iterative fast Walsh-Hadamard transform along axis 0.

    x: (n, ...) with n a power of two. Returns H @ x with H the *unnormalized*
    ±1 Hadamard matrix (HᵀH = n·I), radix-2 butterflies as in the reference.
    """
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError(f"FWHT needs a power-of-two length, got {n}")
    rest = tuple(x.shape[1:])
    h = 1
    while h < n:
        y = x.reshape((n // (2 * h), 2, h) + rest)
        a, b = y[:, 0], y[:, 1]
        x = torch.stack([a + b, a - b], dim=1).reshape((n,) + rest)
        h *= 2
    return x


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()
