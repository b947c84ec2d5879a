"""SJLT S·A and sketch→Gram wrappers: the CUDA kernels on the card, the plain
versions on the CPU.

For the sparse JL sketch with s nonzeros ±1/√s per data row, its parameters a
pure function of (key, row) (``sjlt_params``), ``sjlt_apply(key, A, m, s)`` and
``sjlt_apply_multi(keys, A, m, s)`` return S·A, and ``sjlt_gram`` and
``sjlt_gram_multi`` return G = (SA)ᵀ(SA). On a CPU tensor they call the plain
versions (``ref.py``, segment sums); on a CUDA tensor they launch the kernels
(``kernel.py`` and ``gram.py``, ``csrc/sjlt_gram.cu``) or raise. Slice w of a
multi form is bitwise equal to the single form on ``keys[w]``.

``LAUNCHES[name]`` counts the calls into the kernels' C entries that wrapper
``name`` made: one per single-key call, one per chunk of workers
(``cuda.worker_chunk``) for a multi form.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import common
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
    return kernel.sjlt_tiles(key.reshape(1, 2), A, m, s, launches=LAUNCHES, name="sjlt_apply", row0=row0)[0]


def sjlt_apply_multi(keys: torch.Tensor, A: torch.Tensor, m: int, s: int) -> torch.Tensor:
    """All q workers' S_w·A (q, m, d), launched together in chunks of
    ``cuda.worker_chunk`` workers."""
    if A.device.type == "cpu":
        return ref.sketch_multi(keys, A, m, s)
    return kernel.sjlt_tiles(keys, A, m, s, launches=LAUNCHES, name="sjlt_apply_multi")
