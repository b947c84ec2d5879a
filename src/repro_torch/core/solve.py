"""Least squares and sketch-and-solve: one worker of Algorithm 1 (PyTorch port).

Port of ``repro.core.solve`` (``lstsq`` qr/chol, ``lstsq_gram``,
``sketch_and_solve`` fused/qr, ``least_norm`` and the right-sketch
``sketch_least_norm`` of §V, ``residual_cost``, ``relative_error``). The small
factorizations stay with ``torch.linalg``, as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch

from repro_torch.core import operators, sketches as sk
from repro_torch.kernels import common


def _solve_tri(T: torch.Tensor, B: torch.Tensor, *, upper: bool) -> torch.Tensor:
    """``T⁻¹B`` for a vector or matrix B (torch's solver wants a matrix)."""
    vec = B.ndim == T.ndim - 1
    X = torch.linalg.solve_triangular(T, B.unsqueeze(-1) if vec else B, upper=upper)
    return X.squeeze(-1) if vec else X


def lstsq(A: torch.Tensor, b: torch.Tensor, *, reg: float = 0.0, method: str = "qr") -> torch.Tensor:
    """argmin_x ‖Ax − b‖² + reg·‖x‖², A: (n, d), b: (n,) or (n, k); matrix
    products in full float32 (TF32 off)."""
    with common.full_fp32_matmul():
        return _lstsq(A, b, reg=reg, method=method)


def _lstsq(A: torch.Tensor, b: torch.Tensor, *, reg: float, method: str) -> torch.Tensor:
    d = A.shape[1]
    if method == "qr":
        if reg > 0.0:
            eye = reg**0.5 * torch.eye(d, dtype=A.dtype, device=A.device)
            A = torch.cat([A, eye], dim=0)
            b = torch.cat([b, torch.zeros((d,) + tuple(b.shape[1:]), dtype=b.dtype, device=b.device)])
        Q, R = torch.linalg.qr(A)
        return _solve_tri(R, Q.T @ b, upper=True)
    if method == "chol":
        G = A.T @ A + reg * torch.eye(d, dtype=A.dtype, device=A.device)
        return lstsq_gram(G, A.T @ b)
    if method == "cg":
        raise NotImplementedError("lstsq(method='cg') is not ported yet (ROADMAP.md Queue 1, 'solvers')")
    raise ValueError(f"unknown method {method!r}")


def lstsq_gram(G: torch.Tensor, c: torch.Tensor, *, reg: float = 0.0) -> torch.Tensor:
    """Solve ``(G + reg·I) x = c`` by Cholesky — the d×d tail of the fused path.

    Batched over leading dimensions: G (..., d, d) with c (..., d) or (..., d, k).
    """
    d = G.shape[-1]
    L = torch.linalg.cholesky(G + reg * torch.eye(d, dtype=G.dtype, device=G.device))
    y = _solve_tri(L, c, upper=False)
    return _solve_tri(L.mT, y, upper=True)


def least_norm(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """min ‖x‖² s.t. Ax = b (n < d, full row rank): x = Aᵀ(AAᵀ)⁻¹b by Cholesky and
    two triangular solves; matrix products in full float32 (TF32 off)."""
    with common.full_fp32_matmul():
        L = torch.linalg.cholesky(A @ A.T)
        z = _solve_tri(L.T, _solve_tri(L, b, upper=False), upper=True)
        return A.T @ z


def sketch_and_solve(
    spec: sk.SketchSpec,
    key: torch.Tensor,
    A: torch.Tensor,
    b: torch.Tensor,
    *,
    reg: float = 0.0,
    method: str = "fused",
    block_rows: int = operators.DEFAULT_BLOCK_ROWS,
) -> torch.Tensor:
    """One worker of Algorithm 1: x̂ = argmin_x ‖S(Ax − b)‖² with S ~ spec.

    ``method="fused"`` streams ``(G, c)`` in one pass over ``[A | b]`` (the fused
    kernel when ``spec.use_kernel``) and solves d×d by Cholesky; ``"qr"``/``"chol"``
    materialize ``(SA, Sb)`` (the S·A kernel when ``spec.use_kernel``) and
    factorize — the two-pass reference.
    """
    if method == "fused":
        G, c = operators.gram_blocked(spec, key, A, b, block_rows=block_rows)
        return lstsq_gram(G, c, reg=reg)
    SA, Sb = sk.sketch_data(spec, key, A, b)
    return lstsq(SA, Sb, reg=reg, method=method)


def sketch_least_norm(spec: sk.SketchSpec, key: torch.Tensor, A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One worker of the right-sketch least-norm problem (§V, n < d):
    ẑ = argmin ‖z‖² s.t. (ASᵀ)z = b;  x̂ = Sᵀẑ.

    ``ASᵀ = (S Aᵀ)ᵀ`` is one forward application of the operator to Aᵀ (the S·A
    or FWHT kernel with ``spec.use_kernel``), and ``Sᵀẑ`` is its adjoint, taken
    from ``op.apply_with_adjoint``: with ``spec.use_kernel`` a Gaussian S (alone
    or inside the hybrid) is written by its S·A kernel and read back by the
    kept-S adjoint kernel where it fits the scratch, else drawn again by the
    Gaussian adjoint kernel; a scatter, the FWHT or a gather for the other kinds.
    A leverage right sketch gets unit scores: over the rows of I_d it is uniform
    sampling with replacement, as in the reference.
    """
    d = A.shape[1]
    scores = torch.ones((d,), dtype=A.dtype, device=A.device) if spec.kind == "leverage" else None
    op = operators.make_operator(spec, key, d, scores=scores, device=A.device)
    SAt, adjoint = op.apply_with_adjoint(A.T)  # (m, n) = S @ Aᵀ
    return adjoint(least_norm(SAt.T, b))


def residual_cost(A: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f(x) = ‖Ax − b‖²."""
    r = A @ x - b
    return torch.sum(r * r)


def relative_error(A, b, x, fstar) -> torch.Tensor:
    """(f(x) − f(x*)) / f(x*) — the paper's 'approximation error'."""
    return (residual_cost(A, b, x) - fstar) / fstar
