"""Launches of the fast Walsh-Hadamard transform CUDA kernel (``csrc/fwht.cu``).

Counterpart of the reference's ``kernels/fwht/kernel.py`` ``fwht_tiles`` (body
``_fwht_tile_kernel``), which the TPU ran as two Kronecker matrix products per
tile on the MXU: on Hopper it is a radix-2 butterfly in registers and shared
memory, in passes of at most 10 stages, in the plain version's stage order, so
the two are bitwise equal. Two entries: the full transform (``fwht_tiles``) and
the SRHT's S·A on the same passes (``srht_forward_tiles``: the diagonal at the
first pass's loads, only the sampled rows written by the last).
"""
from __future__ import annotations

import collections

import torch


def fwht_tiles(x: torch.Tensor, *, launches: collections.Counter, name: str) -> torch.Tensor:
    """H·x for the CUDA tensor x (n, k) float32, n a power of two (H unnormalised);
    ``launches[name]`` gains one per call into the kernel's C entry."""
    from repro_torch.kernels import cuda

    return cuda.fwht(x, launches=launches, name=name)


def srht_forward_tiles(kd0: int, kd1: int, rows: torch.Tensor, A: torch.Tensor, n_pad: int, *,
                       launches: collections.Counter, name: str) -> torch.Tensor:
    """(H·pad(D·A, n_pad))[rows] · inv_sqrt(m) for the CUDA tensor A (n, k) float32;
    ``launches[name]`` gains one per call into the kernel's C entry."""
    from repro_torch.kernels import cuda

    return cuda.srht_forward(kd0, kd1, rows, A, n_pad, launches=launches, name=name)
