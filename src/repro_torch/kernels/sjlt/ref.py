"""Plain PyTorch versions of the SJLT S·A and sketch→Gram kernels.

The reference's segment-sum (``repro.kernels.sjlt.ref``):
data row i adds ``signs[i, t]·A[i]`` into sketch row ``buckets[i, t]``, t < s,
with the parameters from ``common.sjlt_counter_params``, over blocks of data
rows, in float64; then the Gram in full float32. Each sketch row adds its pairs
(data row i, t) one after another in that order, as ``index_add_`` does on the
CPU, by a segmented sum over the pairs sorted stably by bucket: on the card
``index_add_`` would add them with float atomics, in an order that changes run
to run. So the sums are the same on every device and run.

:func:`bin_pairs` is the plain version of the kernels' bin pass (the binned pair
list the scatter pass reads) and :func:`sketch_from_bins` adds a list back into
S·A, so the CPU tests can hold the list's order against the reference's pairs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.cuda import SJLT_BLOCK_COLS, SJLT_CLASSES, SjltPlan

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
           block_rows: int = PLAIN_BLOCK_ROWS, row0: int = 0) -> torch.Tensor:
    """S·A ∈ R^{m×d}, float32, with parameters drawn ``block_rows`` rows at a time;
    the signed rows are summed in float64 and rounded once, as the dense plain
    versions do. ``row0``: the data row A's first row is (S[:, row0 : row0 + n]·A)."""
    k0, k1 = common.key_words(key)
    n, d = A.shape
    acc = torch.zeros((m, d), dtype=torch.float64, device=A.device)
    for j0 in range(0, n, block_rows):
        blk = A[j0 : j0 + block_rows].to(torch.float64)
        rows = row0 + j0 + torch.arange(blk.shape[0], dtype=torch.int64, device=A.device)
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


def bin_pairs(key: torch.Tensor, n: int, m: int, s: int, plan: SjltPlan) -> torch.Tensor:
    """The bin pass's list for ``key``: (chunks, region_ints) int64 words (uint32
    values). Region c holds chunk c's bin offsets (bin = m-tile · 32 +
    (bucket − m0) mod 32, SJLT_CLASSES classes), its entry count, zeros to a
    whole 16 bytes, then its entries sorted stably by bin (pair order (i, t)
    inside a bin), each bin padded to a multiple of 4 entries with pads, zeros
    after. An entry packs (bucket − m0)·32, (row − row0)·32 << 16 and the sign
    (1: negative) << 31 (32 = SJLT_BLOCK_COLS, the floats of an accumulator row
    and of a staged X row); a pad of the bin of class k is (spare_row + k)·32."""
    k0, k1 = common.key_words(key)
    rows = torch.arange(n, dtype=torch.int64)
    buckets, signs = common.sjlt_counter_params(k0, k1, rows, s, m)
    chunk = (rows // plan.chunk_rows)[:, None].expand(n, s).reshape(-1)
    r = (rows % plan.chunk_rows)[:, None].expand(n, s).reshape(-1)
    b = buckets.reshape(-1)
    tile = b // plan.bucket_tile
    lb = b - tile * plan.bucket_tile
    bin_ = tile * SJLT_CLASSES + lb % SJLT_CLASSES
    ent = lb * SJLT_BLOCK_COLS | (r * 32) << 16 | (signs.reshape(-1) < 0).to(torch.int64) << 31
    counts = torch.bincount(chunk * plan.bins + bin_, minlength=plan.chunks * plan.bins).reshape(plan.chunks, -1)
    padded = (counts + 3) // 4 * 4
    starts = padded.cumsum(1) - padded
    out = torch.zeros((plan.chunks, plan.region_ints), dtype=torch.int64)
    out[:, : plan.bins] = starts
    out[:, plan.bins] = padded.sum(1)
    # Real entries: each bin's start plus the entry's rank among the chunk's pairs of its bin.
    order = torch.sort(chunk * plan.bins + bin_, stable=True).indices
    c_o, b_o = chunk[order], bin_[order]
    first = torch.searchsorted(c_o * plan.bins + b_o, c_o * plan.bins + b_o, side="left")
    rank = torch.arange(n * s) - first
    out[c_o, plan.hdr_ints + starts[c_o, b_o] + rank] = ent[order]
    # Pads: the bin's spare row, X's row 0, positive.
    c_p, b_p = torch.nonzero(padded > counts, as_tuple=True)
    for j in range(3):
        more = counts[c_p, b_p] + j < padded[c_p, b_p]
        cj, bj = c_p[more], b_p[more]
        out[cj, plan.hdr_ints + starts[cj, bj] + counts[cj, bj] + j] = (plan.spare_row + bj % SJLT_CLASSES) * SJLT_BLOCK_COLS
    return out


def sketch_from_bins(lists: torch.Tensor, A: torch.Tensor, m: int, s: int, plan: SjltPlan) -> torch.Tensor:
    """S·A (m, d) float32 from a worker's binned pair list (:func:`bin_pairs`),
    each pair read back from its entry and its bin (the pads skipped), summed in
    float64."""
    n, d = A.shape
    lists = lists.to(torch.int64) & common.MASK32
    idx = torch.arange(plan.region_ints - plan.hdr_ints)
    acc = torch.zeros((m, d), dtype=torch.float64)
    for c in range(plan.chunks):
        hdr, ent = lists[c, : plan.bins + 1], lists[c, plan.hdr_ints :]
        live = idx < hdr[plan.bins]
        tile = (torch.searchsorted(hdr[: plan.bins], idx[live], right=True) - 1) // SJLT_CLASSES
        ent = ent[live]
        lb = (ent & 0xFFFF) // SJLT_BLOCK_COLS
        real = lb < plan.bucket_tile
        bucket = (tile * plan.bucket_tile + lb)[real]
        row = c * plan.chunk_rows + ((ent[real] >> 16) & 0x7FFF) // 32
        sign = 1.0 - 2.0 * (ent[real] >> 31).double()
        acc.index_add_(0, bucket, sign[:, None] * A[row].double())
    return (acc * common.inv_sqrt(s)).float()
