"""Plain PyTorch versions of the Gaussian S·A, sketch→Gram and adjoint kernels.

They materialize the same counter-derived S the kernels generate tile by tile
(threefry2x32 + Box-Muller, element (i, j) keyed by counters (i, j)), in blocks
of data rows, and contract it with plain matrix products. The CPU path of every
wrapper in ``ops.py`` is this module; on the card it is the version the kernels
are compared with.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common

PLAIN_BLOCK_ROWS = 8192


def columns(k0: int, k1: int, m: int, j0: int, block: int, device=None) -> torch.Tensor:
    """``S[:, j0 : j0+block]``, S ~ N(0, 1/m) from the counter stream."""
    rows = torch.arange(m, dtype=torch.int64, device=device)[:, None]
    cols = j0 + torch.arange(block, dtype=torch.int64, device=device)[None, :]
    z = common.counter_normal(k0, k1, rows, cols)
    return z * common.inv_sqrt(m)


def sketch_matrix(key: torch.Tensor, m: int, n: int, *, device=None) -> torch.Tensor:
    """The full S ∈ R^{m×n} (small problems only)."""
    k0, k1 = common.key_words(key)
    return columns(k0, k1, m, 0, n, device)


def gaussian_gram(
    key: torch.Tensor, A: torch.Tensor, m: int, *, block_rows: int = PLAIN_BLOCK_ROWS
) -> torch.Tensor:
    """G = (SA)ᵀ(SA) ∈ R^{d×d}, float32, with S drawn in blocks of ``block_rows`` columns."""
    return common.plain_gram(columns, key, A, m, block_rows)


def gaussian_gram_multi(keys: torch.Tensor, A: torch.Tensor, m: int) -> torch.Tensor:
    """(q, d, d): slice w is :func:`gaussian_gram` on ``keys[w]``."""
    return torch.stack([gaussian_gram(k, A, m) for k in keys])


def sketch(key: torch.Tensor, A: torch.Tensor, m: int, *, block_rows: int = PLAIN_BLOCK_ROWS,
           row0: int = 0) -> torch.Tensor:
    """S·A ∈ R^{m×d}, float32, with S drawn in blocks of ``block_rows`` columns;
    ``S[:, row0 : row0 + n]·A`` with ``row0``."""
    return common.plain_sketch(columns, key, A, m, block_rows, row0)


def sketch_multi(keys: torch.Tensor, A: torch.Tensor, m: int) -> torch.Tensor:
    """(q, m, d): slice w is :func:`sketch` on ``keys[w]``."""
    return torch.stack([sketch(k, A, m) for k in keys])


def adjoint(key: torch.Tensor, Y: torch.Tensor, n: int, *, block_rows: int = PLAIN_BLOCK_ROWS) -> torch.Tensor:
    """Sᵀ·Y ∈ R^{n×k} in float32 for Y (m, k), S ∈ R^{m×n} drawn by :func:`columns` in
    blocks of ``block_rows`` of its n columns. The float32 S and Y are multiplied
    and summed in float64 and rounded once (the exact Sᵀ·Y of the same S, as
    ``common.plain_sketch`` does for S·A)."""
    k0, k1 = common.key_words(key)
    m = Y.shape[0]
    Yd = Y.to(torch.float64)
    out = torch.empty((n, Y.shape[1]), dtype=torch.float32, device=Y.device)
    for j0 in range(0, n, block_rows):
        blk = min(block_rows, n - j0)
        out[j0 : j0 + blk] = (columns(k0, k1, m, j0, blk, Y.device).double().T @ Yd).float()
    return out


def adjoint_kept(S: torch.Tensor, Y: torch.Tensor, n: int) -> torch.Tensor:
    """Sᵀ·Y ∈ R^{n×k} in float32 for Y (m, k) and a materialized S (m, ≥ n), its
    columns ``:n``: multiplied and summed in float64 and rounded once, as
    :func:`adjoint` does with the S it draws."""
    return (S[:, :n].double().T @ Y.double()).float()
