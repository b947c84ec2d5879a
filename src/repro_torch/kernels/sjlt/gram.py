"""Launch of the fused SJLT sketch→Gram CUDA kernel (``csrc/sjlt_gram.cu``).

Counterpart of the reference's ``kernels/sjlt/gram.py`` ``sjlt_gram_tiles`` and
``sjlt_gram_tiles_multi``: a sparse sketch pass (O(n·s·d), not the TPU's one-hot
product) with the parameters drawn in-core, then the dense families' split
reduction and Gram pass.
"""
from __future__ import annotations

import collections

import torch


def sjlt_gram_tiles(keys: torch.Tensor, X: torch.Tensor, m: int, s: int, *,
                    launches: collections.Counter, name: str) -> torch.Tensor:
    """(q, d, d) Grams of the CUDA tensor X (n, d) float32 for (q, 2) key words;
    ``launches[name]`` gains one per call into the kernel's C entry."""
    from repro_torch.kernels import cuda

    return cuda.sjlt_gram(keys, X, m, s, launches=launches, name=name)
