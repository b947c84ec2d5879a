"""Plain PyTorch versions of the SJLT S·A and sketch→Gram kernels.

The reference's segment-sum (``repro.kernels.sjlt.ref``) with ``index_add_``:
data row i adds ``signs[i, t]·A[i]`` into sketch row ``buckets[i, t]``, t < s,
with the parameters from ``common.sjlt_counter_params``, over blocks of data
rows, in float64; then the Gram in full float32. On the card ``index_add_``
sums with atomics, in no fixed order: there this version is the one the kernel
is held against to tolerance, never a bitwise reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common

PLAIN_BLOCK_ROWS = 4096


def sjlt_apply(A: torch.Tensor, buckets: torch.Tensor, signs: torch.Tensor, m: int,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """(SA) for the SJLT given by (buckets, signs), each (n, s); A (n, d) float32.
    Adds into ``out`` (m, d) when given, else into zeros."""
    n, s = buckets.shape
    vals = (signs[..., None] * A[:, None, :]).reshape(n * s, A.shape[1])
    if out is None:
        out = torch.zeros((m, A.shape[1]), dtype=A.dtype, device=A.device)
    return out.index_add_(0, buckets.reshape(-1), vals)


def sketch(key: torch.Tensor, A: torch.Tensor, m: int, s: int, *,
           block_rows: int = PLAIN_BLOCK_ROWS) -> torch.Tensor:
    """S·A ∈ R^{m×d}, float32, with parameters drawn ``block_rows`` rows at a time;
    the signed rows are summed in float64 and rounded once (as the dense plain
    versions do), so the atomics' order on the card does not show."""
    k0, k1 = common.key_words(key)
    n, d = A.shape
    acc = torch.zeros((m, d), dtype=torch.float64, device=A.device)
    for j0 in range(0, n, block_rows):
        blk = A[j0 : j0 + block_rows].to(torch.float64)
        rows = j0 + torch.arange(blk.shape[0], dtype=torch.int64, device=A.device)
        buckets, signs = common.sjlt_counter_params(k0, k1, rows, s, m, dtype=torch.float64)
        sjlt_apply(blk, buckets, signs, m, out=acc)
    return acc.float()


def sketch_multi(keys: torch.Tensor, A: torch.Tensor, m: int, s: int) -> torch.Tensor:
    """(q, m, d): slice w is :func:`sketch` on ``keys[w]``."""
    return torch.stack([sketch(k, A, m, s) for k in keys])


def sjlt_gram(key: torch.Tensor, A: torch.Tensor, m: int, s: int, *,
              block_rows: int = PLAIN_BLOCK_ROWS) -> torch.Tensor:
    """G = (SA)ᵀ(SA) ∈ R^{d×d}, float32, with parameters drawn ``block_rows`` rows at a time."""
    acc = sketch(key, A, m, s, block_rows=block_rows)
    with common.full_fp32_matmul():
        return acc.T @ acc


def sjlt_gram_multi(keys: torch.Tensor, A: torch.Tensor, m: int, s: int) -> torch.Tensor:
    """(q, d, d): slice w is :func:`sjlt_gram` on ``keys[w]``."""
    return torch.stack([sjlt_gram(k, A, m, s) for k in keys])
