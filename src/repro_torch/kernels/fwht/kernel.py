"""Launch of the fast Walsh-Hadamard transform CUDA kernel (``csrc/fwht.cu``).

Counterpart of the reference's ``kernels/fwht/kernel.py`` ``fwht_tiles`` (body
``_fwht_tile_kernel``), which the TPU ran as two Kronecker matrix products per
tile on the MXU: on Hopper it is a radix-2 butterfly in registers and shared
memory, in passes of at most 10 stages, in the plain version's stage order, so
the two are bitwise equal.
"""
from __future__ import annotations

import collections

import torch


def fwht_tiles(x: torch.Tensor, *, launches: collections.Counter, name: str) -> torch.Tensor:
    """H·x for the CUDA tensor x (n, k) float32, n a power of two (H unnormalised);
    ``launches[name]`` gains one per call into the kernel's C entry."""
    from repro_torch.kernels import cuda

    return cuda.fwht(x, launches=launches, name=name)
