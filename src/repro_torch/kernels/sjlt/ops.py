"""SJLT S·A and sketch→Gram wrappers: the CUDA kernels on the card, the plain
versions on the CPU.

For the sparse JL sketch with s nonzeros ±1/√s per data row, its parameters a
pure function of (key, row) (``sjlt_params``), ``sjlt_apply(key, A, m, s)`` and
``sjlt_apply_multi(keys, A, m, s)`` return S·A, and ``sjlt_gram`` and
``sjlt_gram_multi`` return G = (SA)ᵀ(SA). On a CPU tensor they call the plain
versions (``ref.py``, segment sums); on a CUDA tensor they launch the kernels
(``kernel.py`` and ``gram.py``, ``csrc/sjlt_gram.cu``) or raise. Slice w of a
multi form is bitwise equal to the single form on ``keys[w]``.

The S·A takes one of two hand-written entries by the shapes alone
(``cuda.sjlt_apply_is_long``): the bin and scatter passes (row 12), or, for at
most 8 columns or an m past their m-tiles, the long-column entry (row 12b:
gradient compression's CountSketch of one long vector). Its calls count as
``sjlt_apply_long`` and ``sjlt_apply_long_multi``. ``sjlt_apply_keep`` is that
entry for one key with the pair list it draws kept, for the CountSketch's
adjoint (``operators.sjlt_adjoint_kept``); it counts as ``sjlt_apply_long``.

``LAUNCHES[name]`` counts the calls into the kernels' C entries that wrapper
``name`` made: one per single-key call, one per chunk of workers
(``cuda.worker_chunk``) for a multi form, one for all workers of a long one.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import common, cuda
from repro_torch.kernels.sjlt import gram, kernel, ref

LAUNCHES: collections.Counter = collections.Counter()


def sjlt_params(key: torch.Tensor, n: int, s: int, m: int, dtype=torch.float32):
    """Bucket indices (int64, (n, s)) and ±1/√s signs of the SJLT for ``key``: the
    only randomness of the sketch, counter-derived per global row, so any block
    of rows can be redrawn on its own (``common.sjlt_counter_params``)."""
    k0, k1 = common.key_words(key)
    return common.sjlt_counter_params(k0, k1, torch.arange(n, dtype=torch.int64), s, m, dtype)


def sjlt_gram(key: torch.Tensor, A: torch.Tensor, m: int, s: int) -> torch.Tensor:
    """G = (SA)ᵀ(SA) ∈ R^{d×d} in one fused pass; pass ``A = [data | b]`` for (G, c)."""
    if A.device.type == "cpu":
        return ref.sjlt_gram(key, A, m, s)
    return gram.sjlt_gram_tiles(key.reshape(1, 2), A, m, s, launches=LAUNCHES, name="sjlt_gram")[0]


def sjlt_gram_multi(keys: torch.Tensor, A: torch.Tensor, m: int, s: int) -> torch.Tensor:
    """All q workers' Grams (q, d, d); workers are launched together, in chunks
    of ``cuda.worker_chunk`` when their partials would outgrow the scratch."""
    if A.device.type == "cpu":
        return ref.sjlt_gram_multi(keys, A, m, s)
    return gram.sjlt_gram_tiles(keys, A, m, s, launches=LAUNCHES, name="sjlt_gram_multi")


def sjlt_apply(key: torch.Tensor, A: torch.Tensor, m: int, s: int, *, row0: int = 0) -> torch.Tensor:
    """S·A ∈ R^{m×d} in float32, the parameters drawn in-core; with ``row0``, the
    row tile ``S[:, row0 : row0 + len(A)]·A`` of a taller A (its pairs drawn at
    the global rows)."""
    if A.device.type == "cpu":
        return ref.sketch(key, A, m, s, row0=row0)
    if cuda.sjlt_apply_is_long(A.shape[0], m, A.shape[1], s):
        return cuda.sjlt_apply_long(key.reshape(1, 2), A, m, s, launches=LAUNCHES, name="sjlt_apply_long",
                                    row0=row0)[0]
    return kernel.sjlt_tiles(key.reshape(1, 2), A, m, s, launches=LAUNCHES, name="sjlt_apply", row0=row0)[0]


def sjlt_apply_multi(keys: torch.Tensor, A: torch.Tensor, m: int, s: int) -> torch.Tensor:
    """All q workers' S_w·A (q, m, d), launched together in chunks of
    ``cuda.worker_chunk`` workers."""
    if A.device.type == "cpu":
        return ref.sketch_multi(keys, A, m, s)
    if cuda.sjlt_apply_is_long(A.shape[0], m, A.shape[1], s):
        return cuda.sjlt_apply_long(keys, A, m, s, launches=LAUNCHES, name="sjlt_apply_long_multi")
    return kernel.sjlt_tiles(keys, A, m, s, launches=LAUNCHES, name="sjlt_apply_multi")


def sjlt_apply_keep(key: torch.Tensor, A: torch.Tensor, m: int, s: int):
    """``(S·A, pairs)`` for shapes that take the long-column entry
    (``cuda.sjlt_apply_is_long``): S·A as :func:`sjlt_apply` computes it, and
    the (n·s,) int32 pair list its kernel drew, ``bucket | sign << 31`` in pair
    order (``ref.long_pairs`` on a CPU tensor)."""
    n, d = A.shape
    if A.device.type == "cpu":
        return ref.sketch(key, A, m, s), ref.long_pairs(key, n, m, s)
    if not cuda.sjlt_apply_is_long(n, m, d, s):
        raise ValueError(f"the pair list is kept by the long-column entry only; (n, m, d, s) = {(n, m, d, s)} "
                         f"takes the bin and scatter passes")
    out, pairs = cuda.sjlt_apply_long(key.reshape(1, 2), A, m, s, launches=LAUNCHES, name="sjlt_apply_long",
                                      keep_pairs=True)
    return out[0], pairs
