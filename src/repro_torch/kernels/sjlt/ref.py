"""Plain PyTorch versions of the SJLT S·A and sketch→Gram kernels.

The reference's segment-sum (``repro.kernels.sjlt.ref``):
data row i adds ``signs[i, t]·A[i]`` into sketch row ``buckets[i, t]``, t < s,
with the parameters from ``common.sjlt_counter_params``, over blocks of data
rows, in float64; then the Gram in full float32. Each sketch row adds its pairs
(data row i, t) one after another in that order, as ``index_add_`` does on the
CPU, by a segmented sum over the pairs sorted stably by bucket: on the card
``index_add_`` would add them with float atomics, in an order that changes run
to run. So the sums are the same on every device and run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common

PLAIN_BLOCK_ROWS = 4096


def sjlt_apply(A: torch.Tensor, buckets: torch.Tensor, signs: torch.Tensor, m: int,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """(SA) for the SJLT given by (buckets, signs), each (n, s); A (n, d) float32.
    Adds into ``out`` (m, d) when given (in place, each row first in its sum),
    else into zeros."""
    n, s = buckets.shape
    flat = buckets.reshape(-1)
    vals = (signs[..., None] * A[:, None, :]).reshape(n * s, A.shape[1])
    if out is not None:
        flat = torch.cat([torch.arange(m, dtype=flat.dtype, device=flat.device), flat])
        vals = torch.cat([out, vals])
    order = torch.sort(flat, stable=True).indices
    lengths = torch.bincount(flat, minlength=m)
    sums = torch.segment_reduce(vals[order], "sum", lengths=lengths, axis=0)
    return sums if out is None else out.copy_(sums)


def sketch(key: torch.Tensor, A: torch.Tensor, m: int, s: int, *,
           block_rows: int = PLAIN_BLOCK_ROWS) -> torch.Tensor:
    """S·A ∈ R^{m×d}, float32, with parameters drawn ``block_rows`` rows at a time;
    the signed rows are summed in float64 and rounded once, as the dense plain
    versions do."""
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
