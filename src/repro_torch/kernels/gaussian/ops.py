"""Gaussian S·A, sketch→Gram and adjoint wrappers: the CUDA kernels on the card,
the plain versions on the CPU.

For S ~ N(0, 1/m) drawn from the counter stream, ``gaussian_sketch(key, A, m)``
and ``gaussian_sketch_multi(keys, A, m)`` return S·A, ``gaussian_gram(key, A,
m)`` and ``gaussian_gram_multi(keys, A, m)`` return G = (SA)ᵀ(SA), and
``gaussian_adjoint(key, Y, n)`` returns Sᵀ·Y for S ∈ R^{m×n}, m = len(Y). On a
CPU tensor they call the plain versions (``ref.py``); on a CUDA tensor they
launch the kernels (``kernel.py`` and ``gram.py``: ``csrc/sketch_gram.cu``,
``csrc/adjoint.cu``) or raise.
The single-key wrappers launch the same code with q = 1, so slice w of a multi
form is bitwise equal to the single form on ``keys[w]``.

``LAUNCHES[name]`` counts the calls into the kernels' C entries (each a sketch
pass and a split reduction, and for a Gram a Gram pass) that wrapper ``name``
made: one per single-key call and per adjoint, one per chunk of workers
(``cuda.worker_chunk``) for a multi form.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels.gaussian import gram, kernel, ref

LAUNCHES: collections.Counter = collections.Counter()


def gaussian_gram(key: torch.Tensor, A: torch.Tensor, m: int) -> torch.Tensor:
    """G = (SA)ᵀ(SA) ∈ R^{d×d} in one fused pass; pass ``A = [data | b]`` for (G, c)."""
    if A.device.type == "cpu":
        return ref.gaussian_gram(key, A, m)
    return gram.gaussian_gram_tiles(key.reshape(1, 2), A, m, launches=LAUNCHES, name="gaussian_gram")[0]


def gaussian_gram_multi(keys: torch.Tensor, A: torch.Tensor, m: int) -> torch.Tensor:
    """All q workers' Grams (q, d, d); workers are launched together, in chunks
    of ``cuda.worker_chunk`` when their partials would outgrow the scratch."""
    if A.device.type == "cpu":
        return ref.gaussian_gram_multi(keys, A, m)
    return gram.gaussian_gram_tiles(keys, A, m, launches=LAUNCHES, name="gaussian_gram_multi")


def gaussian_sketch(key: torch.Tensor, A: torch.Tensor, m: int) -> torch.Tensor:
    """S·A ∈ R^{m×d} in float32, S drawn in-core."""
    if A.device.type == "cpu":
        return ref.sketch(key, A, m)
    return kernel.gaussian_tiles(key.reshape(1, 2), A, m, launches=LAUNCHES, name="gaussian_sketch")[0]


def gaussian_sketch_multi(keys: torch.Tensor, A: torch.Tensor, m: int) -> torch.Tensor:
    """All q workers' S_w·A (q, m, d), launched together in chunks of
    ``cuda.worker_chunk`` workers."""
    if A.device.type == "cpu":
        return ref.sketch_multi(keys, A, m)
    return kernel.gaussian_tiles(keys, A, m, launches=LAUNCHES, name="gaussian_sketch_multi")


def gaussian_adjoint(key: torch.Tensor, Y: torch.Tensor, n: int) -> torch.Tensor:
    """Sᵀ·Y ∈ R^{n×k} (or R^n) for Y (m, k) or (m,) float32, S ~ N(0, 1/m)^{m×n}
    drawn in-core: the same S as ``gaussian_sketch`` with this key."""
    Y2 = Y.reshape(Y.shape[0], -1)
    if Y.device.type == "cpu":
        out = ref.adjoint(key, Y2, n)
    else:
        out = kernel.gaussian_adjoint_tiles(key, Y2, n, launches=LAUNCHES, name="gaussian_adjoint")
    return out[:, 0] if Y.ndim == 1 else out
