"""FWHT, SRHT forward and SRHT sketch→Gram wrappers: the CUDA kernels on the
card, the plain versions on the CPU.

``fwht(x)`` is the unnormalised Walsh-Hadamard transform H·x along axis 0 of x
(n, k), n a power of two: the plain ``sketches._fwht`` on a CPU tensor, the
butterfly kernel (``kernel.py``, ``csrc/fwht.cu`` ``repro_fwht``) on a CUDA
tensor, bitwise equal to each other.

``srht_forward(kd0, kd1, rows, A, n_pad)`` is the SRHT's S·A (m, k):
``fwht(pad(D·A, n_pad))[rows] · inv_sqrt(m)``, the plain composition
(``ref.srht_forward``) on a CPU tensor, one call into ``repro_srht_forward``
(the diagonal at the first pass's loads, only the m sampled rows written) on a
CUDA tensor, bitwise equal to each other.

``srht_gram(key_words, rows, A)`` and ``srht_gram_multi(key_words, rows, A)``
return G = (SA)ᵀ(SA) for the SRHT S = (1/√m)·P·H·D with sampled Hadamard rows
``rows`` ((m,) or (q, m)) and the diagonal D keyed by ``key_words`` ((2,) or
(q, 2); ``SRHTOp.build`` derives both from a worker key). On a CPU tensor they
call the plain version (``ref.py``); on a CUDA tensor they launch the kernel
(``gram.py``, ``csrc/sketch_gram.cu``) or raise. Slice w of the multi form is
bitwise equal to the single form on ``key_words[w]``, ``rows[w]``.

``LAUNCHES[name]`` counts the calls into the kernels' C entries that wrapper
``name`` made: one per ``fwht`` or ``srht_forward`` call (all its passes) and
single-key Gram, one per chunk of workers (``cuda.worker_chunk``) for the multi
Gram.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels.fwht import gram, kernel, ref

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


def fwht(x: torch.Tensor) -> torch.Tensor:
    """H·x (n, k) float32, H the unnormalised ±1 Hadamard matrix of order n."""
    if x.device.type == "cpu":
        return ref.fwht(x)
    return kernel.fwht_tiles(x, launches=LAUNCHES, name="fwht")


def srht_forward(kd0: int, kd1: int, rows: torch.Tensor, A: torch.Tensor, n_pad: int) -> torch.Tensor:
    """S·A (m, k) float32 for S = (1/√m)·P·H·D on the n_pad padding: D keyed by the
    words (kd0, kd1), P the (m,) sampled Hadamard row ids ``rows``."""
    if A.device.type == "cpu":
        return ref.srht_forward(kd0, kd1, rows, A, n_pad)
    return kernel.srht_forward_tiles(kd0, kd1, rows, A, n_pad, launches=LAUNCHES, name="srht_forward")
