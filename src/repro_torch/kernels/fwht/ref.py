"""Plain PyTorch versions of the FWHT, the SRHT forward and the SRHT sketch→Gram
kernels.

The FWHT's is ``sketches._fwht`` (radix-2 butterflies in the order h = 1, 2,
4, ...), re-exported here as :func:`fwht`. The SRHT forward's,
:func:`srht_forward`, is the composition ``SRHTOp.apply`` made before the fused
kernel: D·A, zero rows up to n_pad, the full FWHT, the sampled rows times
1/√m. The SRHT Gram's materialize S tiles from the Sylvester closed form
``S[r, j] = (1/√m)·(−1)^popcount(rows[r] & j)·D[j]`` (``rows`` the sampled
Hadamard row ids, D the Rademacher diagonal from ``counter_rademacher(kd, j, 0)``,
j the global data row) in blocks of data rows, and contract them with plain
matrix products in full float32. PyTorch has no popcount, so the parity of
``rows[r] & j`` is folded with xor-shifts in int64.
"""
from __future__ import annotations

import torch

from repro_torch.core.sketches import _fwht as fwht  # noqa: F401  (the FWHT kernel's plain version)
from repro_torch.kernels import common

PLAIN_BLOCK_ROWS = 8192


def parity(x: torch.Tensor) -> torch.Tensor:
    """popcount(x) & 1 for int64 tensors holding values below 2**32."""
    for shift in (16, 8, 4, 2, 1):
        x = x ^ (x >> shift)
    return x & 1


def diagonal(kd0: int, kd1: int, j: torch.Tensor) -> torch.Tensor:
    """D[j] = ±1 (float32) at the global data rows j."""
    return common.counter_rademacher(kd0, kd1, j, 0)


def srht_forward(kd0: int, kd1: int, rows: torch.Tensor, A: torch.Tensor, n_pad: int) -> torch.Tensor:
    """(H·pad(D·A, n_pad))[rows] · inv_sqrt(m), (m, k) float32, for A (n, k), the
    diagonal key words (kd0, kd1) and the (m,) sampled Hadamard row ids."""
    n = A.shape[0]
    DA = A.to(torch.float32) * diagonal(kd0, kd1, torch.arange(n, dtype=torch.int64, device=A.device))[:, None]
    if n_pad != n:
        DA = torch.cat([DA, DA.new_zeros((n_pad - n, DA.shape[1]))])
    return fwht(DA)[rows.to(A.device)] * common.inv_sqrt(rows.shape[0])


def columns(kd0: int, kd1: int, rows: torch.Tensor, j0: int, block: int, device=None) -> torch.Tensor:
    """``S[:, j0 : j0+block]`` for sampled Hadamard rows ``rows`` (m,) and diagonal
    key words (kd0, kd1), as an (m, block) float32 tile."""
    j = j0 + torch.arange(block, dtype=torch.int64, device=device)
    r = rows.to(device=device, dtype=torch.int64)
    h = (1 - 2 * parity(r[:, None] & j[None, :])).to(torch.float32)
    return h * diagonal(kd0, kd1, j)[None, :] * common.inv_sqrt(r.shape[0])


def srht_gram(key_words: torch.Tensor, rows: torch.Tensor, A: torch.Tensor, *,
              block_rows: int = PLAIN_BLOCK_ROWS) -> torch.Tensor:
    """G = (SA)ᵀ(SA) ∈ R^{d×d}, float32, S in blocks of ``block_rows`` columns;
    ``key_words`` the (2,) diagonal key, ``rows`` the (m,) sampled row ids."""
    def tile(k0, k1, m, j0, blk, device):
        return columns(k0, k1, rows, j0, blk, device)

    return common.plain_gram(tile, key_words, A, rows.shape[0], block_rows)


def srht_gram_multi(key_words: torch.Tensor, rows: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """(q, d, d): slice w is :func:`srht_gram` on ``key_words[w]``, ``rows[w]``."""
    return torch.stack([srht_gram(k, r, A) for k, r in zip(key_words, rows)])
