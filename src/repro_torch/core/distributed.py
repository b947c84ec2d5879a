"""Algorithm 1 on one GPU: q sketch-and-solve workers and the master's average,
and the §V right-sketch least-norm average.

Port of three entry points of ``repro.core.distributed``. The q workers are a
batch over worker keys on one device (the reference shards them over a mesh;
multi-GPU ``torch.distributed`` is a later slice). Worker w of round r uses
``prng.worker_key(key, w, r)``, the reference's key, so both packages draw the
same sketches.

A straggler mask with no survivor raises: an empty round has no estimator.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import averaging, operators, sketches as sk, solve
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


def _checked_mask(straggler_mask, q: int, device) -> torch.Tensor:
    """Default / validate the straggler mask; raise on an empty round."""
    if straggler_mask is None:
        return torch.ones((q,), dtype=torch.float32, device=device)
    mask = torch.as_tensor(straggler_mask, dtype=torch.float32)
    if tuple(mask.shape) != (q,):
        raise ValueError(f"straggler_mask must have shape ({q},), got {tuple(mask.shape)}")
    if float(mask.sum()) == 0:
        raise ValueError(
            "straggler_mask has no surviving workers (q' = 0): the Algorithm-1 "
            "average over an empty set is undefined. Loosen the deadline or "
            "resubmit the round."
        )
    return mask.to(device)


def distributed_sketch_solve(
    spec: sk.SketchSpec,
    key: torch.Tensor,
    A: torch.Tensor,
    b: torch.Tensor,
    *,
    q: int,
    round_id: int = 0,
    straggler_mask=None,
    reg: float = 0.0,
    method: str = "fused",
    on_empty: str = "nan",
    device=None,
) -> torch.Tensor:
    """Algorithm 1 with worker-side sketches: each of the q workers solves
    ``solve.sketch_and_solve(..., method=method)`` on its own key and the master
    averages the arrivals. ``method="fused"`` (default) streams ``(G_k, c_k)``
    from [A | b] (the fused single-key kernel when ``spec.use_kernel``) and
    solves d×d; ``"qr"``/``"chol"`` is the two-pass reference: S_k[A | b] (the
    S·A kernel when ``spec.use_kernel``), then a factorization.

    ``device``: ``None`` means CUDA (raises when absent); pass ``"cpu"`` for the CPU.
    Returns x̄ (d,) or (d, k).
    """
    dev = resolve_device(device)
    A, b = A.to(dev), b.to(dev)
    mask = _checked_mask(straggler_mask, q, dev)
    keys = prng.worker_keys(key, q, round_id)
    xs = torch.stack([solve.sketch_and_solve(spec, keys[w], A, b, reg=reg, method=method) for w in range(q)])
    return averaging.masked_average(xs, mask, on_empty=on_empty)


def distributed_sketch_solve_master(
    spec: sk.SketchSpec,
    key: torch.Tensor,
    A: torch.Tensor,
    b: torch.Tensor,
    *,
    q: int,
    round_id: int = 0,
    straggler_mask=None,
    reg: float = 0.0,
    method: str = "fused",
    on_empty: str = "nan",
    device=None,
) -> torch.Tensor:
    """Algorithm 1 in master-sketch mode (the paper's privacy deployment: only the
    master touches raw rows; workers see only sketch products).

    ``method="fused"`` (default): the master streams all q fused Grams in one
    batched pass over [A | b] (the multi-worker kernel when ``spec.use_kernel``)
    and each worker solves its d×d system. Any other method is the two-pass
    reference: the master forms every ``(S_k A, S_k b)``
    (``operators.sketch_data_batched``; the multi-worker S·A kernel when
    ``spec.use_kernel`` and the kind has one) and each worker factorizes its
    m×d problem (``solve.lstsq(..., method=method)``). The master averages the
    arrivals. Worker keys match :func:`distributed_sketch_solve`, so the two
    modes agree to float tolerance.
    """
    dev = resolve_device(device)
    A, b = A.to(dev), b.to(dev)
    mask = _checked_mask(straggler_mask, q, dev)
    keys = prng.worker_keys(key, q, round_id)
    if method == "fused":
        Gs, cs = operators.gram_batched(spec, keys, A, b)
        xs = solve.lstsq_gram(Gs, cs, reg=reg)
    else:
        SA, Sb = operators.sketch_data_batched(spec, keys, A, b)
        xs = torch.stack([solve.lstsq(SA[w], Sb[w], reg=reg, method=method) for w in range(q)])
    return averaging.masked_average(xs, mask, on_empty=on_empty)


def distributed_sketch_least_norm(
    spec: sk.SketchSpec,
    key: torch.Tensor,
    A: torch.Tensor,
    b: torch.Tensor,
    *,
    q: int,
    round_id: int = 0,
    straggler_mask=None,
    on_empty: str = "nan",
    device=None,
) -> torch.Tensor:
    """§V right-sketch averaging (n < d): each of the q workers solves
    ``solve.sketch_least_norm`` on its own key (the S·A kernel forward and, for the
    Gaussian, the adjoint kernel when ``spec.use_kernel``) and the master
    averages the arrivals. Aᵀ is made contiguous once per call and shared by the
    workers' forward sketches; what each worker computes does not change.

    ``device``: ``None`` means CUDA (raises when absent); pass ``"cpu"`` for the CPU.
    Returns x̄ (d,) or (d, k).
    """
    dev = resolve_device(device)
    A, b = A.to(dev), b.to(dev)
    mask = _checked_mask(straggler_mask, q, dev)
    keys = prng.worker_keys(key, q, round_id)
    A = A.T.contiguous().T  # a view whose transpose is contiguous: no copy per worker
    xs = torch.stack([solve.sketch_least_norm(spec, keys[w], A, b) for w in range(q)])
    return averaging.masked_average(xs, mask, on_empty=on_empty)
