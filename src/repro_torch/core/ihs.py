"""Iterative Hessian Sketch (Pilanci & Wainwright 2016), the baseline the paper
compares its one-shot averaging against (port of ``repro.core.ihs``).

IHS refines x_t with a fresh sketched Hessian each iteration,

    x_{t+1} = x_t + (Aᵀ S_tᵀ S_t A)⁻¹ Aᵀ (b − A x_t),

converging geometrically but in synchronous rounds (each iteration needs the
previous iterate). The sketches are independent of the iterates and IHS reads
``S_t A`` only through its Gram, so all ``iters`` Hessians come from one
``operators.gram_batched`` call over ``worker_keys(key, iters)`` (with
``spec.use_kernel``, one multi-worker sketch→Gram kernel launch per chunk of
keys on the card). The refinement is a Python loop of d×d Cholesky solves; its
gradients ``Aᵀ(b − A x)`` are full-float32 matrix products (TF32 off), as the
reference computes them outside any kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import operators, sketches as sk, solve
from repro_torch.kernels import common
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


def _ihs_iterates(spec: sk.SketchSpec, key: torch.Tensor, A: torch.Tensor, b: torch.Tensor, iters: int,
                  reg: float, device) -> torch.Tensor:
    """The (iters, d) iterates x_1 .. x_iters from x_0 = 0."""
    dev = resolve_device(device)
    A, b = A.to(dev), b.to(dev)
    d = A.shape[1]
    Gs, _ = operators.gram_batched(spec, prng.worker_keys(key, iters), A)
    x = torch.zeros((d,), dtype=A.dtype, device=dev)
    out = []
    with common.full_fp32_matmul():
        for G in Gs:
            g = A.T @ (b - A @ x)
            x = x + solve.lstsq_gram(G.to(A.dtype), g, reg=reg)
            out.append(x)
    return torch.stack(out)


def ihs_solve(spec: sk.SketchSpec, key: torch.Tensor, A: torch.Tensor, b: torch.Tensor, *,
              iters: int = 10, reg: float = 0.0, device=None) -> torch.Tensor:
    """Run ``iters`` IHS iterations; spec.m should be >= ~2d for geometric decay.

    ``device``: ``None`` means CUDA (raises when absent); pass ``"cpu"`` for the CPU."""
    return _ihs_iterates(spec, key, A, b, iters, reg, device)[-1]


def ihs_trace(spec: sk.SketchSpec, key: torch.Tensor, A: torch.Tensor, b: torch.Tensor, *,
              iters: int = 10, reg: float = 0.0, device=None) -> torch.Tensor:
    """Like :func:`ihs_solve` but returns the (iters, d) iterate after every step."""
    return _ihs_iterates(spec, key, A, b, iters, reg, device)
