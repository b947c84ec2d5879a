"""Launch of the fused SRHT sketch→Gram CUDA kernel (``csrc/sketch_gram.cu``).

Counterpart of the reference's ``kernels/fwht/gram.py`` ``srht_gram_tiles`` and
``srht_gram_tiles_multi``: the dense families' tensor-core sketch pass with the
Sylvester closed form drawn as one sign word per sketch row and 32 data rows (a
popcount per word, the diagonal at 20 threefry rounds), two TF32 products.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import common


def srht_gram_tiles(key_words: torch.Tensor, rows: torch.Tensor, X: torch.Tensor, *,
                    launches: collections.Counter, name: str) -> torch.Tensor:
    """(q, d, d) Grams of the CUDA tensor X (n, d) float32 for (q, 2) diagonal key
    words and (q, m) sampled row ids; ``launches[name]`` gains one per call into
    the kernel's C entry."""
    from repro_torch.kernels import cuda

    return cuda.sketch_gram("srht", key_words, X, rows.shape[-1], rounds=common.DEFAULT_ROUNDS,
                            launches=launches, name=name, srht_rows=rows)
