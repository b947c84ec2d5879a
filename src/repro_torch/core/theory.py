"""Closed-form predictions from the paper (port of ``repro.core.theory``).

  * Lemma 1  : E[f(x̂)] − f(x*) = f(x*) · d/(m−d−1)      (single Gaussian sketch)
  * Theorem 1: E[f(x̄)] − f(x*) = f(x*) · d/(q(m−d−1))   (averaged, exact)
  * Lemma 2  : error(q) = variance/q + bias²·(q−1)/q      (any i.i.d. sketch)
  * Lemma 4/5/6 : bias bounds for ROS / uniform / leverage sketches
  * Lemma 7  : E‖x̂−x*‖² = f(x*)·(d−n)/(m−n−1)           (right sketch, n<d)
"""
from __future__ import annotations

import math

import torch


def gaussian_single_error(m: int, d: int) -> float:
    """Lemma 1: relative expected error of one Gaussian-sketched solution."""
    if m <= d + 1:
        raise ValueError("Lemma 1 requires m > d + 1")
    return d / (m - d - 1)


def gaussian_averaged_error(m: int, d: int, q: int) -> float:
    """Theorem 1: relative expected error of the q-average (exact, unbiased)."""
    return gaussian_single_error(m, d) / q


def gaussian_least_norm_error(m: int, n: int, d: int) -> float:
    """Lemma 7: E‖x̂−x*‖²/f(x*) for the right sketch (n < d)."""
    if m <= n + 1:
        raise ValueError("Lemma 7 requires m > n + 1")
    return (d - n) / (m - n - 1)


def theorem1_success_probability(m: int, d: int, q: int, eps: float, c1: float = 0.1) -> float:
    """Theorem 1's lower bound on P[(f(x̄)−f(x*))/f(x*) ≤ ε/q]."""
    p_inv = 1.0 - math.exp(-c1 * m)
    factor = 1.0 - (1.0 / eps) * d / (m - d - 1)
    return max(0.0, p_inv**q * factor)


def lemma2_error(variance: float, bias_sq: float, q: int) -> float:
    """E[f(x̄)] − f(x*) = variance/q + bias²·(q−1)/q."""
    return variance / q + bias_sq * (q - 1) / q


def empirical_bias_variance(Axhats: torch.Tensor, Axstar: torch.Tensor):
    """Monte-Carlo estimates of the Lemma-2 components from stacked predictions.

    Axhats: (trials, n) of A@x̂ samples; Axstar: (n,). Returns
    (E‖Ax̂ − Ax*‖², ‖E[Ax̂] − Ax*‖²), the 1/q and (q−1)/q coefficients."""
    diffs = Axhats - Axstar[None, :]
    variance_term = torch.mean(torch.sum(diffs * diffs, dim=1))
    mean_diff = torch.mean(diffs, dim=0)
    return variance_term, torch.sum(mean_diff * mean_diff)


def ros_z_bound(m: int, d: int, fstar: float, min_row_leverage: float = 0.0) -> float:
    """Lemma 4: E‖z‖² ≤ (d/m)(1 − 2·min_i‖ũ_i‖²/d)·f(x*)."""
    return (d / m) * (1.0 - 2.0 * min_row_leverage / d) * fstar


def ros_bias_bound(eps: float, m: int, d: int, fstar: float) -> float:
    """Lemma 4 (eq. 9): ‖E[Ax̂] − Ax*‖ ≤ sqrt(4ε·(d/m)·f(x*))."""
    return math.sqrt(4.0 * eps * (d / m) * fstar)


def uniform_z_bound(m: int, n: int, fstar: float, max_row_leverage: float, *, replacement: bool = True) -> float:
    """Lemma 5: E‖z‖² bounds for uniform sampling (with / without replacement)."""
    base = (n / m) * fstar * max_row_leverage
    if replacement:
        return base
    return base * (n - m) / (n - 1)


def uniform_bias_bound(eps: float, m: int, n: int, fstar: float, max_row_leverage: float, *,
                       replacement: bool = True) -> float:
    """Lemma 5 (eqs. 12-13)."""
    return math.sqrt(4.0 * eps * uniform_z_bound(m, n, fstar, max_row_leverage, replacement=replacement))


def leverage_z_bound(m: int, d: int, fstar: float) -> float:
    """Lemma 6: E‖z‖² ≤ (d/m)·f(x*)."""
    return (d / m) * fstar


def leverage_bias_bound(eps: float, m: int, d: int, fstar: float) -> float:
    """Lemma 6 (eq. 15)."""
    return math.sqrt(4.0 * eps * (d / m) * fstar)


def subspace_embedding_eps(U: torch.Tensor, S_applied_U: torch.Tensor) -> torch.Tensor:
    """Empirical ε such that (1−ε)I ⪯ (UᵀSᵀSU)⁻¹ ⪯ (1+ε)I (Lemma 3's assumption):
    max(|eig((UᵀSᵀSU)⁻¹) − 1|), the products in full float32 (TF32 off)."""
    from repro_torch.kernels import common

    with common.full_fp32_matmul():
        G = S_applied_U.T @ S_applied_U
        w = torch.linalg.eigvalsh(torch.linalg.inv(G))
    return torch.max(torch.abs(w - 1.0))


def workers_for_error(m: int, d: int, eps: float) -> int:
    """Paper §I: #workers for target relative error ε scales as 1/ε (Gaussian)."""
    return max(1, math.ceil(gaussian_single_error(m, d) / eps))
