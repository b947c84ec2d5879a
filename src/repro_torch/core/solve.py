"""Least squares and sketch-and-solve: one worker of Algorithm 1 (PyTorch port).

Port of ``repro.core.solve`` (``lstsq`` qr/chol/cg, ``lstsq_gram``,
``sketch_and_solve`` fused/qr/chol/cg, ``least_norm`` and the right-sketch
``sketch_least_norm`` of §V, ``residual_cost``, ``relative_error``). The small
factorizations stay with ``torch.linalg``, as the reference leaves them to XLA.
A Cholesky factorization that fails (a Gram that is not positive definite)
gives NaN for the solutions it should have produced, batch entry by batch
entry, as ``jnp.linalg.cholesky`` does; nothing raises, and nothing waits on
the card to look at the factorization's status.
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
        return _cg_normal(A, b, reg=reg)
    raise ValueError(f"unknown method {method!r}")


def _vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum of all products of x and y (``jnp.vdot`` for real x, y of any shape)."""
    return torch.sum(x * y)


def _cg_normal(A: torch.Tensor, b: torch.Tensor, *, reg: float = 0.0, iters: int = 64) -> torch.Tensor:
    """CG on the normal equations (AᵀA + reg·I)x = Aᵀb, matrix-free, a fixed
    ``iters`` steps from x = 0 (the reference's loop, its 1e-30 guards included)."""

    def mv(x):
        return A.T @ (A @ x) + reg * x

    rhs = A.T @ b
    x = torch.zeros_like(rhs)
    r = rhs - mv(x)
    p = r
    rs = _vdot(r, r)
    for _ in range(iters):
        Ap = mv(p)
        alpha = rs / (_vdot(p, Ap) + 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = _vdot(r, r)
        p = r + (rs_new / (rs + 1e-30)) * p
        rs = rs_new
    return x


def _cholesky(G: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Lower Cholesky factor of (..., d, d) G and a (...,) mask of the batch
    entries whose factorization failed (``info`` ≠ 0: G not positive definite)."""
    L, info = torch.linalg.cholesky_ex(G)
    return L, info != 0


def _nan_where(x: torch.Tensor, failed: torch.Tensor) -> torch.Tensor:
    """x with every batch entry that ``failed`` marks set to NaN (x's batch dims
    lead, as failed's do)."""
    mask = failed.reshape(tuple(failed.shape) + (1,) * (x.ndim - failed.ndim))
    return torch.where(mask, torch.full_like(x, float("nan")), x)


def lstsq_gram(G: torch.Tensor, c: torch.Tensor, *, reg: float = 0.0) -> torch.Tensor:
    """Solve ``(G + reg·I) x = c`` by Cholesky — the d×d tail of the fused path.

    Batched over leading dimensions: G (..., d, d) with c (..., d) or (..., d, k).
    A batch entry whose G + reg·I is not positive definite gets NaN, as the
    reference's ``jnp.linalg.cholesky`` gives; the others are untouched.
    """
    d = G.shape[-1]
    L, failed = _cholesky(G + reg * torch.eye(d, dtype=G.dtype, device=G.device))
    y = _solve_tri(L, c, upper=False)
    return _nan_where(_solve_tri(L.mT, y, upper=True), failed)


def least_norm(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """min ‖x‖² s.t. Ax = b (n < d, full row rank): x = Aᵀ(AAᵀ)⁻¹b by Cholesky and
    two triangular solves; matrix products in full float32 (TF32 off). NaN when
    AAᵀ is not positive definite, as in the reference."""
    with common.full_fp32_matmul():
        L, failed = _cholesky(A @ A.T)
        z = _solve_tri(L.T, _solve_tri(L, b, upper=False), upper=True)
        return _nan_where(A.T @ z, failed)


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
    kernel when ``spec.use_kernel``) and solves d×d by Cholesky;
    ``"qr"``/``"chol"``/``"cg"`` materialize ``(SA, Sb)`` (the S·A kernel when
    ``spec.use_kernel``) and factorize or iterate — the two-pass reference.
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
