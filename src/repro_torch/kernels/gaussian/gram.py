"""Launch of the fused Gaussian sketch→Gram CUDA kernel (``csrc/sketch_gram.cu``).

Counterpart of the reference's ``kernels/gaussian/gram.py`` ``gaussian_gram_tiles``
and ``gaussian_gram_tiles_multi``: one skeleton serves both, launched with q key
rows (q = 1 for the single-key form). The Gaussian stream uses
``REPRO_RNG_ROUNDS`` threefry rounds, passed to the kernel as an argument.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import common


def gaussian_gram_tiles(keys: torch.Tensor, X: torch.Tensor, m: int, *,
                        launches: collections.Counter, name: str) -> torch.Tensor:
    """(q, d, d) Grams of the CUDA tensor X (n, d) float32 for (q, 2) key words;
    ``launches[name]`` gains one per call into the kernel's C entry."""
    from repro_torch.kernels import cuda

    return cuda.sketch_gram("gaussian", keys, X, m, rounds=common.rng_rounds(),
                            launches=launches, name=name)
