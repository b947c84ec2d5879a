"""Closed-form Gaussian predictions from the paper (port of ``repro.core.theory``).

  * Lemma 1  : E[f(x̂)] − f(x*) = f(x*) · d/(m−d−1)      (single Gaussian sketch)
  * Theorem 1: E[f(x̄)] − f(x*) = f(x*) · d/(q(m−d−1))   (averaged, exact)
"""
from __future__ import annotations


def gaussian_single_error(m: int, d: int) -> float:
    """Lemma 1: relative expected error of one Gaussian-sketched solution."""
    if m <= d + 1:
        raise ValueError("Lemma 1 requires m > d + 1")
    return d / (m - d - 1)


def gaussian_averaged_error(m: int, d: int, q: int) -> float:
    """Theorem 1: relative expected error of the q-average (exact, unbiased)."""
    return gaussian_single_error(m, d) / q
