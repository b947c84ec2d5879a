"""PyTorch/CUDA port of the distributed sketching package (``repro``).

The JAX package ``repro`` stays the reference; this package mirrors its module
layout (``core/``, ``kernels/``, ``utils/``, ``data/``, ``configs/``) and imports
nothing from it, nor from JAX. Its entry points run on the CUDA device unless
the caller passes ``device="cpu"``; the fused sketch→Gram kernels are hand-written
CUDA C++ under ``csrc/``, built with ``nvcc`` at first use.
"""
