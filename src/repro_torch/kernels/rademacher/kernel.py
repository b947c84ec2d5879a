"""Launch of the Rademacher S·A CUDA kernel (``csrc/sketch_apply.cu``, entry
``repro_sketch_apply``).

Counterpart of the reference's ``kernels/rademacher/kernel.py``
``rademacher_tiles``: S·X on the tensor cores with packed-sign S tiles (always 20
threefry rounds), ±1 exact in TF32, so two TF32 products (X's hi and lo parts)
and the 1/√m scale after the sum.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import common


def rademacher_tiles(keys: torch.Tensor, X: torch.Tensor, m: int, *,
                     launches: collections.Counter, name: str, row0: int = 0) -> torch.Tensor:
    """(q, m, d) sketches S_w X of the CUDA tensor X (n, d) float32 for (q, 2) key
    words (``S_w[:, row0 : row0 + n]·X`` with ``row0``, a multiple of 32);
    ``launches[name]`` gains one per call into the kernel's C entry."""
    from repro_torch.kernels import cuda

    return cuda.sketch_apply("rademacher", keys, X, m, rounds=common.DEFAULT_ROUNDS,
                             launches=launches, name=name, row0=row0)
