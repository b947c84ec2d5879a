"""Gaussian S·A, sketch→Gram and adjoint wrappers: the CUDA kernels on the card,
the plain versions on the CPU.

For S ~ N(0, 1/m) drawn from the counter stream, ``gaussian_sketch(key, A, m)``
and ``gaussian_sketch_multi(keys, A, m)`` return S·A, ``gaussian_gram(key, A,
m)`` and ``gaussian_gram_multi(keys, A, m)`` return G = (SA)ᵀ(SA), and
``gaussian_adjoint(key, Y, n)`` returns Sᵀ·Y for S ∈ R^{m×n}, m = len(Y).
``gaussian_sketch_keep(key, A, m)`` returns (S·A, S): S·A bitwise
``gaussian_sketch``'s and the S it drew, which ``gaussian_adjoint_kept(S, Y, n)``
reads back for Sᵀ·Y (the right-sketch least-norm path, where a worker's forward
and adjoint share one S and ``cuda.keeps_sketch(m, n)`` says it fits).
On a CPU tensor they call the plain versions (``ref.py``); on a CUDA tensor they
launch the kernels (``kernel.py`` and ``gram.py``: ``csrc/sketch_apply.cu``,
``csrc/sketch_gram.cu``, ``csrc/adjoint.cu``) or raise.
The single-key wrappers launch the same code with q = 1, so slice w of a multi
form is bitwise equal to the single form on ``keys[w]``.

``LAUNCHES[name]`` counts the calls into the kernels' C entries (each a sketch
pass, a split reduction where the plan has more than one split, and for a Gram a
Gram pass) that wrapper ``name``
made: one per single-key call and per adjoint, one per chunk of workers
(``cuda.worker_chunk``) for a multi form. ``gaussian_sketch_keep`` counts under
``gaussian_sketch`` (the same kernel), ``gaussian_adjoint_kept`` under its own name.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import cuda
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


def gaussian_sketch(key: torch.Tensor, A: torch.Tensor, m: int, *, row0: int = 0) -> torch.Tensor:
    """S·A ∈ R^{m×d} in float32, S drawn in-core; with ``row0``, the row tile
    ``S[:, row0 : row0 + len(A)]·A`` of a taller A (its first row being row0)."""
    if A.device.type == "cpu":
        return ref.sketch(key, A, m, row0=row0)
    return kernel.gaussian_tiles(key.reshape(1, 2), A, m, launches=LAUNCHES, name="gaussian_sketch", row0=row0)[0]


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


def gaussian_sketch_keep(key: torch.Tensor, A: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(S·A, S)``: S·A ∈ R^{m×d} as :func:`gaussian_sketch` gives it, and the S it
    drew, (m, ld) float32 with its n = len(A) columns first (on the card ld is n
    up to a multiple of 4)."""
    if A.device.type == "cpu":
        return ref.sketch(key, A, m), ref.sketch_matrix(key, m, A.shape[0])
    return kernel.gaussian_tiles_keep(key, A, m, launches=LAUNCHES, name="gaussian_sketch")


def gaussian_adjoint_kept(S: torch.Tensor, Y: torch.Tensor, n: int) -> torch.Tensor:
    """Sᵀ·Y ∈ R^{n×k} (or R^n) for Y (m, k) or (m,) float32 and S from
    :func:`gaussian_sketch_keep`, read instead of drawn."""
    Y2 = Y if Y.ndim == 2 else Y.reshape(Y.shape[0], -1)  # a call on a (m, k) Y stays lean
    if Y2.is_cpu:
        out = ref.adjoint_kept(S, Y2, n)
    else:  # its host path is the call's whole cost at FIG4A's size, so no layer between
        out = cuda.gaussian_adjoint_kept(S, Y2, n, launches=LAUNCHES, name="gaussian_adjoint_kept")
    return out if Y.ndim == 2 else out[:, 0]
