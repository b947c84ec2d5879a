"""Rademacher S·A and sketch→Gram wrappers: the CUDA kernels on the card, the plain
versions on the CPU.

For S = ±1/√m from packed counter signs (one threefry word per 32 entries,
always 20 rounds), ``rademacher_sketch(key, A, m)`` and
``rademacher_sketch_multi(keys, A, m)`` return S·A, and ``rademacher_gram`` and
``rademacher_gram_multi`` return G = (SA)ᵀ(SA). On a CPU tensor they call the
plain versions (``ref.py``); on a CUDA tensor they launch the kernels
(``kernel.py`` and ``gram.py``: ``csrc/sketch_apply.cu``, ``csrc/sketch_gram.cu``)
or raise. Slice w of a
multi form is bitwise equal to the single form on ``keys[w]``.

``LAUNCHES[name]`` counts the calls into the kernels' C entries that wrapper
``name`` made: one per single-key call, one per chunk of workers
(``cuda.worker_chunk``) for a multi form.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels.rademacher import gram, kernel, ref

LAUNCHES: collections.Counter = collections.Counter()


def rademacher_gram(key: torch.Tensor, A: torch.Tensor, m: int) -> torch.Tensor:
    """G = (SA)ᵀ(SA) ∈ R^{d×d} in one fused pass; pass ``A = [data | b]`` for (G, c)."""
    if A.device.type == "cpu":
        return ref.rademacher_gram(key, A, m)
    return gram.rademacher_gram_tiles(key.reshape(1, 2), A, m, launches=LAUNCHES, name="rademacher_gram")[0]


def rademacher_gram_multi(keys: torch.Tensor, A: torch.Tensor, m: int) -> torch.Tensor:
    """All q workers' Grams (q, d, d); workers are launched together, in chunks
    of ``cuda.worker_chunk`` when their partials would outgrow the scratch."""
    if A.device.type == "cpu":
        return ref.rademacher_gram_multi(keys, A, m)
    return gram.rademacher_gram_tiles(keys, A, m, launches=LAUNCHES, name="rademacher_gram_multi")


def rademacher_sketch(key: torch.Tensor, A: torch.Tensor, m: int, *, row0: int = 0) -> torch.Tensor:
    """S·A ∈ R^{m×d} in float32, the signs drawn in-core; with ``row0`` (on the
    card a multiple of 32: whole sign words), the row tile
    ``S[:, row0 : row0 + len(A)]·A`` of a taller A."""
    if A.device.type == "cpu":
        return ref.sketch(key, A, m, row0=row0)
    return kernel.rademacher_tiles(key.reshape(1, 2), A, m, launches=LAUNCHES, name="rademacher_sketch",
                                   row0=row0)[0]


def rademacher_sketch_multi(keys: torch.Tensor, A: torch.Tensor, m: int) -> torch.Tensor:
    """All q workers' S_w·A (q, m, d), launched together in chunks of
    ``cuda.worker_chunk`` workers."""
    if A.device.type == "cpu":
        return ref.sketch_multi(keys, A, m)
    return kernel.rademacher_tiles(keys, A, m, launches=LAUNCHES, name="rademacher_sketch_multi")
