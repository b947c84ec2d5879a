"""Row 12b's arithmetic in plain PyTorch, for the tests only.

``repro_sjlt_apply_long`` (``csrc/sjlt_gram.cu``) sums each (bucket, column)
entry's terms as integers at a power of two of its own. :func:`sketch_fixed_point`
repeats that arithmetic, so a CPU test can hold it against the plain SJLT S·A
(``repro_torch.kernels.sjlt.ref.sketch``) and a card test can hold the kernel
to it bit for bit.
"""
import torch

from repro_torch.kernels import common


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k in float64, exactly, for integer k in [-1022, 1023]: its exponent bits
    (``torch.ldexp`` and ``exp2`` go through ``pow``, which need not be exact)."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def fixed_point_sum(b: torch.Tensor, x: torch.Tensor, m: int, inv_sqrt_s: float) -> torch.Tensor:
    """(m, d) float32 as ``repro_sjlt_apply_long`` sums terms t = inv_sqrt_s·x[k]
    (x (pairs, d) float32, the signed values; t exact in float64) into rows
    b[k]: entry (b, c) sums the integers round(t·2^S), S = 188 − e − ⌈log₂ L⌉
    with e the largest float32 exponent field of its column-c values and L its
    pair count, then rounds the sum to float32 and scales it by 2^−S; an entry
    with a non-finite term is that term's ±inf, or NaN (a NaN, or both
    infinities). The sums are of integers: the order of the pairs is free."""
    d = x.shape[1]
    terms = inv_sqrt_s * x.double()
    count = torch.bincount(b, minlength=m)
    expo = (x.view(torch.int32) >> 23) & 0xFF
    e_max = torch.zeros((m, d), dtype=torch.int32, device=x.device).scatter_reduce_(
        0, b[:, None].expand(-1, d), expo, "amax")
    clog = torch.where(count > 1, torch.ceil(torch.log2(count.double().clamp_min(1))), 0).to(torch.int64)
    shift = 188 - e_max.to(torch.int64) - clog[:, None]
    finite = e_max < 255
    fixed = torch.round(terms * _pow2(shift[b])).to(torch.int64)
    fixed = torch.where(finite[b], fixed, torch.zeros_like(fixed))
    acc = torch.zeros((m, d), dtype=torch.int64, device=x.device).index_add_(0, b, fixed)
    out = (acc.to(torch.float32).double() * _pow2(-shift)).to(torch.float32)
    inf = torch.zeros((m, d), dtype=torch.float64, device=x.device).index_add_(
        0, b, torch.where(torch.isfinite(terms), torch.zeros_like(terms), terms))
    return torch.where(finite, out, inf.to(torch.float32))


def sketch_fixed_point(key: torch.Tensor, A: torch.Tensor, m: int, s: int, *, row0: int = 0) -> torch.Tensor:
    """S·A (m, d) float32 as ``repro_sjlt_apply_long`` computes it
    (:func:`fixed_point_sum` of its pairs' terms ±A[i, c]/√s)."""
    k0, k1 = common.key_words(key)
    n, d = A.shape
    rows = row0 + torch.arange(n, dtype=torch.int64, device=A.device)
    buckets, signs = common.sjlt_counter_params(k0, k1, rows, s, m, dtype=torch.float64)
    x = A.to(torch.float32)[:, None, :].expand(n, s, d).reshape(n * s, d)
    return fixed_point_sum(buckets.reshape(-1), torch.where(signs.reshape(-1, 1) < 0, -x, x), m, common.inv_sqrt(s))
