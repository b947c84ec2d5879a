"""SRHT sketch→Gram wrappers: the CUDA kernel on the card, the plain version on the CPU.

``srht_gram(key_words, rows, A)`` and ``srht_gram_multi(key_words, rows, A)``
return G = (SA)ᵀ(SA) for the SRHT S = (1/√m)·P·H·D with sampled Hadamard rows
``rows`` ((m,) or (q, m)) and the diagonal D keyed by ``key_words`` ((2,) or
(q, 2); ``SRHTOp.build`` derives both from a worker key). On a CPU tensor they
call the plain version (``ref.py``); on a CUDA tensor they launch the kernel
(``gram.py``, ``csrc/sketch_gram.cu``) or raise. Slice w of the multi form is
bitwise equal to the single form on ``key_words[w]``, ``rows[w]``.

``LAUNCHES[name]`` counts the calls into the kernel's C entry (each a sketch
pass, a split reduction and a Gram pass) that wrapper ``name`` made: one per
single-key call, one per chunk of workers (``cuda.worker_chunk``) for the
multi form.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels.fwht import gram, ref

LAUNCHES: collections.Counter = collections.Counter()


def srht_gram(key_words: torch.Tensor, rows: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """G = (SA)ᵀ(SA) ∈ R^{d×d} in one fused pass; pass ``A = [data | b]`` for (G, c)."""
    if A.device.type == "cpu":
        return ref.srht_gram(key_words, rows, A)
    return gram.srht_gram_tiles(key_words.reshape(1, 2), rows.reshape(1, -1), A,
                                launches=LAUNCHES, name="srht_gram")[0]


def srht_gram_multi(key_words: torch.Tensor, rows: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """All q workers' Grams (q, d, d); workers are launched together, in chunks
    of ``cuda.worker_chunk`` when their partials would outgrow the scratch."""
    if A.device.type == "cpu":
        return ref.srht_gram_multi(key_words, rows, A)
    return gram.srht_gram_tiles(key_words, rows, A, launches=LAUNCHES, name="srht_gram_multi")
