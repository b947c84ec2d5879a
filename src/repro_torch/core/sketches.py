"""Sketch configuration, leverage scores and the functional API (port of
``repro.core.sketches``).

``SketchSpec`` and ``KINDS`` are the reference's, field for field, so a spec
means the same thing to both packages, and every kind has an operator
(:mod:`repro_torch.core.operators`):

  * ``gaussian``, ``rademacher`` — dense counter-RNG sketches;
  * ``srht``                     — randomized Hadamard (ROS);
  * ``uniform``, ``leverage``    — row sampling (uniform, or by leverage score);
  * ``sjlt``                     — sparse JL with ``s`` nonzeros per column;
  * ``hybrid``                   — uniform sampling of m′ rows, then an inner
                                   sketch m′ → m (the paper's §IV-D proposal).

The plain Walsh-Hadamard transform the SRHT applies lives here, as in the
reference; its CUDA kernel is ``kernels/fwht``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import common

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

    def apply(self, key: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        """Return ``S @ A`` where A has shape (n, ...)."""
        return apply_sketch(self, key, A)

    def operator(self, key: torch.Tensor, n: int, *, scores: Optional[torch.Tensor] = None, device=None):
        """The frozen :class:`repro_torch.core.operators.SketchOp` for this spec
        (``device``: where a sampling kind draws its rows, as for
        ``operators.make_operator``)."""
        from repro_torch.core import operators

        return operators.make_operator(self, key, n, scores=scores, device=device)


def sketch_data(spec: SketchSpec, key: torch.Tensor, A: torch.Tensor, b: torch.Tensor):
    """Sketch (A, b) with the *same* S (Algorithm 1): returns (SA, Sb).

    b may be (n,) or (n, k)."""
    bm = b if b.ndim == 2 else b[:, None]
    d = A.shape[1]
    SAb = apply_sketch(spec, key, torch.cat([A, bm.to(A.dtype)], dim=1))
    Sb = SAb[:, d:]
    return SAb[:, :d], (Sb if b.ndim == 2 else Sb[:, 0])


def materialize(spec: SketchSpec, key: torch.Tensor, n: int, dtype=torch.float32, *,
                device=None) -> torch.Tensor:
    """Materialize S ∈ R^{m×n} explicitly (tests / small problems only): S = S @ I."""
    return apply_sketch(spec, key, torch.eye(n, dtype=dtype, device=device))


def apply_sketch(spec: SketchSpec, key: torch.Tensor, A: torch.Tensor, *,
                 scores: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``S @ A`` along axis 0 of A for the sketch ``spec`` describes (registry
    dispatch; a leverage sketch takes ``scores`` or computes them from A)."""
    from repro_torch.core import operators

    return operators.apply(spec, key, A, scores=scores)


def gaussian_sketch(key, A, m: int, *, use_kernel: bool = False) -> torch.Tensor:
    """S with i.i.d. N(0, 1/m) entries."""
    return apply_sketch(SketchSpec("gaussian", m, use_kernel=use_kernel), key, A)


def rademacher_sketch(key, A, m: int, *, use_kernel: bool = False) -> torch.Tensor:
    """S with i.i.d. ±1/√m entries (packed counter signs)."""
    return apply_sketch(SketchSpec("rademacher", m, use_kernel=use_kernel), key, A)


def srht_sketch(key, A, m: int, *, use_kernel: bool = False) -> torch.Tensor:
    """Randomized Hadamard (ROS): m of n_pad Hadamard rows with replacement."""
    return apply_sketch(SketchSpec("srht", m, use_kernel=use_kernel), key, A)


def uniform_sketch(key, A, m: int, *, replacement: bool = True) -> torch.Tensor:
    """Uniform row sampling, each kept row scaled by √(n/m)."""
    return apply_sketch(SketchSpec("uniform", m, replacement=replacement), key, A)


def leverage_sketch(key, A, m: int, *, scores: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Leverage-score sampling with replacement, row j kept with probability
    p_j ∝ ℓ_j and scaled by 1/√(m·p_j)."""
    return apply_sketch(SketchSpec("leverage", m), key, A, scores=scores)


def sjlt_sketch(key, A, m: int, *, s: int = 4, use_kernel: bool = False) -> torch.Tensor:
    """Sparse JL: s nonzeros ±1/√s per column of S."""
    return apply_sketch(SketchSpec("sjlt", m, s=s, use_kernel=use_kernel), key, A)


def hybrid_sketch(key, A, m: int, m_prime: int, *, inner: str = "gaussian", s: int = 4,
                  use_kernel: bool = False) -> torch.Tensor:
    """Paper §IV-D: uniform-sample m′ rows, then sketch m′ → m with ``inner``."""
    spec = SketchSpec("hybrid", m, m_prime=m_prime, inner=inner, s=s, use_kernel=use_kernel)
    return apply_sketch(spec, key, A)


# ------------------------------------------------------------------ leverage utils


def leverage_scores(A: torch.Tensor, *, method: str = "qr",
                    key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row leverage scores ℓ_i = ‖u_i‖² of A (they sum to rank(A)).

    ``"qr"`` and ``"svd"`` are exact. ``"approx"`` (Drineas et al. 2012) takes R
    from a QR of the plain SRHT sketch of A to m = max(4d, 64) rows, keyed by
    ``key`` (default ``PRNGKey(0)``'s words), and returns ‖a_iᵀR⁻¹‖²; for
    m >= n it is the exact ``"qr"``.
    """
    with common.full_fp32_matmul():
        if method == "svd":
            U = torch.linalg.svd(A, full_matrices=False)[0]
            return torch.sum(U * U, dim=1)
        if method == "qr":
            Q = torch.linalg.qr(A)[0]
            return torch.sum(Q * Q, dim=1)
        if method == "approx":
            n, d = A.shape
            m = max(4 * d, 64)
            if m >= n:
                return leverage_scores(A, method="qr")
            if key is None:
                key = torch.tensor([0, 0], dtype=torch.int64)
            R = torch.linalg.qr(srht_sketch(key, A, m))[1]
            AR = torch.linalg.solve_triangular(R.T, A.T, upper=False).T
            return torch.sum(AR * AR, dim=1)
    raise ValueError(f"unknown leverage method {method!r}")


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
