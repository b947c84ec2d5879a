"""Launch of the Gaussian S·A CUDA kernel (``csrc/sketch_gram.cu``, entry
``repro_sketch_apply``).

Counterpart of the reference's ``kernels/gaussian/kernel.py`` ``gaussian_tiles``:
the sketch pass of the fused sketch→Gram kernel and its split reduction, without
the Gram pass, so S·X is bitwise what the Gram kernel forms its G from. The
Gaussian stream uses ``REPRO_RNG_ROUNDS`` threefry rounds.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import common


def gaussian_tiles(keys: torch.Tensor, X: torch.Tensor, m: int, *,
                   launches: collections.Counter, name: str) -> torch.Tensor:
    """(q, m, d) sketches S_w X of the CUDA tensor X (n, d) float32 for (q, 2) key
    words; ``launches[name]`` gains one per call into the kernel's C entry."""
    from repro_torch.kernels import cuda

    return cuda.sketch_apply("gaussian", keys, X, m, rounds=common.rng_rounds(),
                             launches=launches, name=name)
