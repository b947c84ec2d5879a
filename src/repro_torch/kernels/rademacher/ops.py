"""Rademacher sketch→Gram wrappers: the CUDA kernel on the card, the plain version on the CPU.

``rademacher_gram(key, A, m)`` and ``rademacher_gram_multi(keys, A, m)`` return
G = (SA)ᵀ(SA) for S = ±1/√m from packed counter signs (one threefry word per 32
entries, always 20 rounds). On a CPU tensor they call the plain version
(``ref.py``); on a CUDA tensor they launch the kernel (``gram.py``, ``csrc/sketch_gram.cu``) or
raise. Slice w of the multi form is bitwise equal to the single form on
``keys[w]``.

``LAUNCHES[name]`` counts the calls into the kernel's C entry (each a sketch
pass, a split reduction and a Gram pass) that wrapper ``name`` made: one per
single-key call, one per chunk of workers (``cuda.worker_chunk``) for the
multi form.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels.rademacher import gram, ref

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
