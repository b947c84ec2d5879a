"""Plain PyTorch versions of the Rademacher S·A and sketch→Gram kernels.

They materialize the same packed-contract S the kernels generate (sign(i, j) is
bit ``j % 32`` of ``threefry(key, i, j // 32)[0]``, scaled by 1/√m) in blocks of
data rows and contract it with plain matrix products in full float32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common

PLAIN_BLOCK_ROWS = 8192


def columns(k0: int, k1: int, m: int, j0: int, block: int, device=None) -> torch.Tensor:
    """``S[:, j0 : j0+block]`` with ±1/√m packed-contract entries (any ``j0``)."""
    signs = common.counter_rademacher_block(k0, k1, 0, j0, m, block, device=device)
    return signs * common.inv_sqrt(m)


def sketch_matrix(key: torch.Tensor, m: int, n: int, *, device=None) -> torch.Tensor:
    """The full S ∈ R^{m×n} (small problems only)."""
    k0, k1 = common.key_words(key)
    return columns(k0, k1, m, 0, n, device)


def rademacher_gram(
    key: torch.Tensor, A: torch.Tensor, m: int, *, block_rows: int = PLAIN_BLOCK_ROWS
) -> torch.Tensor:
    """G = (SA)ᵀ(SA) ∈ R^{d×d}, float32, with S drawn in blocks of ``block_rows`` columns."""
    return common.plain_gram(columns, key, A, m, block_rows)


def rademacher_gram_multi(keys: torch.Tensor, A: torch.Tensor, m: int) -> torch.Tensor:
    """(q, d, d): slice w is :func:`rademacher_gram` on ``keys[w]``."""
    return torch.stack([rademacher_gram(k, A, m) for k in keys])


def sketch(key: torch.Tensor, A: torch.Tensor, m: int, *, block_rows: int = PLAIN_BLOCK_ROWS,
           row0: int = 0) -> torch.Tensor:
    """S·A ∈ R^{m×d}, float32, with S drawn in blocks of ``block_rows`` columns;
    ``S[:, row0 : row0 + n]·A`` with ``row0``."""
    return common.plain_sketch(columns, key, A, m, block_rows, row0)


def sketch_multi(keys: torch.Tensor, A: torch.Tensor, m: int) -> torch.Tensor:
    """(q, m, d): slice w is :func:`sketch` on ``keys[w]``."""
    return torch.stack([sketch(k, A, m) for k in keys])
