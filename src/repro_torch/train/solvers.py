"""Sketched linear-head fitting: Algorithm 1 applied to frozen features.

Port of ``repro.train.solvers.fit_head`` and ``head_fit_quality``. A linear map
fit onto frozen backbone features (a probe, a value head, an lm-head re-fit) is
the paper's least squares with the feature matrix H (tokens × d_model) as A
(n ≫ d), so it is fit with the master-sketch mode of Algorithm 1: its
straggler resilience and its privacy accounting come along. ``extract_features``
waits for the port of the LM (``models/lm``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import averaging, operators, privacy, sketches as sk, solve
from repro_torch.kernels import common
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


def fit_head(key: torch.Tensor, H: torch.Tensor, Y: torch.Tensor, spec: sk.SketchSpec, *, q: int = 16,
             reg: float = 1e-4, straggler_mask=None, accountant: Optional[privacy.PrivacyAccountant] = None,
             device=None) -> torch.Tensor:
    """Algorithm 1 on (H, Y): q sketch-and-solve workers, their masked average.

    All q workers' Grams come from one batched pass over [H | Y]
    (``operators.gram_batched``: the multi-worker sketch→Gram kernel with
    ``spec.use_kernel``), each worker solves its d×d ridge system
    (``solve.lstsq_gram`` with ``reg``), and the arrivals of ``straggler_mask``
    (q,) are averaged. With an ``accountant`` each worker's shipment is recorded
    (q disclosures, γ = std(H) in float32, as the reference). Y may be (n,) or
    (n, k); returns W (d,) or (d, k). ``device``: ``None`` means CUDA (raises
    when absent); pass ``"cpu"`` for the CPU.
    """
    dev = resolve_device(device)
    H, Y = H.to(dev), Y.to(dev)
    n = H.shape[0]
    if accountant is not None:
        gamma = float(torch.std(H.to(torch.float32), correction=0))
        for w in range(q):
            accountant.record(spec.m, n, gamma=gamma, tag=f"head-fit worker {w}")
    keys = prng.worker_keys(key, q)
    Gs, cs = operators.gram_batched(spec, keys, H, Y.reshape(n, -1))  # (q, d, d), (q, d, k)
    Ws = solve.lstsq_gram(Gs, cs, reg=reg)  # (q, d, k)
    W = averaging.masked_average(Ws, None if straggler_mask is None else torch.as_tensor(straggler_mask).to(dev))
    return W.reshape(H.shape[1:] + Y.shape[1:]) if Y.ndim > 1 else W[:, 0]


def head_fit_quality(H: torch.Tensor, Y: torch.Tensor, W: torch.Tensor) -> dict:
    """Residual diagnostics against the exact ridge solution (reg 1e-4)."""
    Ym = Y.reshape(H.shape[0], -1)
    W_star = solve.lstsq(H, Ym, reg=1e-4)

    def f(w):
        with common.full_fp32_matmul():
            r = H @ w.reshape(H.shape[1], -1) - Ym
        return float(torch.sum(r * r))

    fs, fw = f(W_star), f(W)
    return {"f_star": fs, "f_sketch": fw, "rel_err": (fw - fs) / max(fs, 1e-30)}
