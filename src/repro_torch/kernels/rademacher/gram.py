"""Launch of the fused Rademacher sketch→Gram CUDA kernel (``csrc/sketch_gram.cu``).

Counterpart of the reference's ``kernels/rademacher/gram.py``
``rademacher_gram_tiles`` and ``rademacher_gram_tiles_multi``: the dense
families' tensor-core sketch pass, S from one packed sign word per sketch row and
32 data rows (always 20 threefry rounds), two TF32 products.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import common


def rademacher_gram_tiles(keys: torch.Tensor, X: torch.Tensor, m: int, *,
                          launches: collections.Counter, name: str) -> torch.Tensor:
    """(q, d, d) Grams of the CUDA tensor X (n, d) float32 for (q, 2) key words;
    ``launches[name]`` gains one per call into the kernel's C entry."""
    from repro_torch.kernels import cuda

    return cuda.sketch_gram("rademacher", keys, X, m, rounds=common.DEFAULT_ROUNDS,
                            launches=launches, name=name)
