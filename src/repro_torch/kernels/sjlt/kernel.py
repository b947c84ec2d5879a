"""Launch of the SJLT S·A CUDA kernel (``csrc/sjlt_gram.cu``, entry
``repro_sjlt_apply``).

Counterpart of the reference's ``kernels/sjlt/kernel.py`` ``sjlt_tiles``. The TPU
kernel takes ``buckets`` and ``signs`` arrays and contracts a one-hot matrix on
the MXU; this one is the sparse sketch pass of the SJLT sketch→Gram kernel
(O(n·s·d), the same ``sjlt_counter_params`` drawn in-core, so S is identical)
and its split reduction, without the Gram pass.
"""
from __future__ import annotations

import collections

import torch


def sjlt_tiles(keys: torch.Tensor, X: torch.Tensor, m: int, s: int, *,
               launches: collections.Counter, name: str, row0: int = 0) -> torch.Tensor:
    """(q, m, d) sketches S_w X of the CUDA tensor X (n, d) float32 for (q, 2) key
    words (``S_w[:, row0 : row0 + n]·X`` with ``row0``); ``launches[name]`` gains
    one per call into the kernel's C entry."""
    from repro_torch.kernels import cuda

    return cuda.sjlt_apply(keys, X, m, s, launches=launches, name=name, row0=row0)
