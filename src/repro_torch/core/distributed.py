"""Algorithm 1: q sketch-and-solve workers and the master's average, its
multi-round form, and the §V right-sketch least-norm average.

Port of four entry points of ``repro.core.distributed``. Worker w of round r
uses ``prng.worker_key(key, w, r)``, the reference's key, so both packages draw
the same sketches. Without a group the q workers are a batch over worker keys
on one device. With ``group`` (a ``torch.distributed`` process group of P ranks,
``launch.mesh.init_worker_group``; the reference's mesh axes) q must be a
multiple of P: rank r runs workers [r·q/P, (r+1)·q/P) as that batch, on the
device it passes, and ``averaging.psum_average`` (one ``all_reduce``) gives
every rank x̄.

Data placement, worker mode (:func:`distributed_sketch_solve`):

* replicated (default) — every worker sketches all of [A | b] (the paper's
  setting);
* ``row_sharded=True`` — worker w sketches only rows [w·n/q, (w+1)·n/q) of A
  **and of b**, its own block (divide-and-conquer "local sketching": biased in
  general, but no raw row crosses ranks). With a group each rank passes only
  its n/P rows, which its q/P workers split in order. The reference's
  ``row_sharded`` pairs each worker's block of A with the first block of b (it
  gives b a replicated spec), which its docstring does not intend; the port
  follows the docstring.

A straggler mask (q,) with no survivor raises: an empty round has no estimator.
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


def _local_workers(q: int, group) -> range:
    """The workers this rank runs: all q without a group, else rank r's
    [r·q/P, (r+1)·q/P)."""
    if group is None:
        return range(q)
    import torch.distributed as dist

    ranks = dist.get_world_size(group)
    if q % ranks:
        raise ValueError(f"q = {q} workers cannot be split evenly over a group of {ranks} ranks")
    per = q // ranks
    r = dist.get_rank(group)
    return range(r * per, (r + 1) * per)


def _average(xs: torch.Tensor, mask: torch.Tensor, workers: range, group, on_empty: str) -> torch.Tensor:
    """The masked average of the local workers' x̂ over every rank of ``group``."""
    return averaging.psum_average(xs, mask[workers.start : workers.stop], group, on_empty=on_empty)


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
    group=None,
    row_sharded: bool = False,
) -> torch.Tensor:
    """Algorithm 1 with worker-side sketches: each of the q workers solves
    ``solve.sketch_and_solve(..., method=method)`` on its own key and the master
    averages the arrivals. ``method="fused"`` (default) streams ``(G_k, c_k)``
    from [A | b] (the fused single-key kernel when ``spec.use_kernel``) and
    solves d×d; ``"qr"``/``"chol"`` is the two-pass reference: S_k[A | b] (the
    S·A kernel when ``spec.use_kernel``), then a factorization.

    ``group``: the ranks that share the q workers (module docstring); every rank
    returns x̄. ``row_sharded``: each worker sketches only its own block of n/q
    rows of A and b (with a group, A and b are this rank's rows, split by its
    q/P workers); raises when the workers do not divide the rows.
    ``device``: ``None`` means CUDA (raises when absent); pass ``"cpu"`` for the CPU.
    Returns x̄ (d,) or (d, k).
    """
    dev = resolve_device(device)
    A, b = A.to(dev), b.to(dev)
    mask = _checked_mask(straggler_mask, q, dev)
    workers = _local_workers(q, group)
    keys = prng.worker_keys(key, q, round_id)[workers.start : workers.stop]
    if row_sharded:
        n, q_local = A.shape[0], len(workers)
        if n % q_local:
            raise ValueError(f"row_sharded: {q_local} workers cannot split {n} rows evenly (q must divide n)")
        blk = n // q_local
        blocks = [(A[i * blk : (i + 1) * blk], b[i * blk : (i + 1) * blk]) for i in range(q_local)]
    else:
        blocks = [(A, b)] * len(workers)
    xs = torch.stack([solve.sketch_and_solve(spec, k, Aw, bw, reg=reg, method=method)
                      for k, (Aw, bw) in zip(keys, blocks)])
    return _average(xs, mask, workers, group, on_empty)


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
    group=None,
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
    modes agree to float tolerance. With ``group`` each rank forms the Grams
    (or sketches) of its own slice of the worker keys, as the reference's mesh
    shards the keys, and every rank returns x̄.
    """
    dev = resolve_device(device)
    A, b = A.to(dev), b.to(dev)
    mask = _checked_mask(straggler_mask, q, dev)
    workers = _local_workers(q, group)
    keys = prng.worker_keys(key, q, round_id)[workers.start : workers.stop]
    if method == "fused":
        Gs, cs = operators.gram_batched(spec, keys, A, b)
        xs = solve.lstsq_gram(Gs, cs, reg=reg)
    else:
        SA, Sb = operators.sketch_data_batched(spec, keys, A, b)
        xs = torch.stack([solve.lstsq(SA[w], Sb[w], reg=reg, method=method) for w in range(len(workers))])
    return _average(xs, mask, workers, group, on_empty)


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
    group=None,
) -> torch.Tensor:
    """§V right-sketch averaging (n < d): each of the q workers solves
    ``solve.sketch_least_norm`` on its own key (the S·A kernel forward and, for the
    Gaussian, the adjoint kernel over the S that forward kept, when
    ``spec.use_kernel``) and the master averages the arrivals. A Gaussian worker
    holds its S (m × d floats) from its forward to its adjoint. Aᵀ is made
    contiguous once per call and shared by the workers' forward sketches; what
    each worker computes does not change.

    ``group``: the ranks that share the q workers, as for
    :func:`distributed_sketch_solve`. ``device``: ``None`` means CUDA (raises
    when absent); pass ``"cpu"`` for the CPU. Returns x̄ (d,) or (d, k).
    """
    dev = resolve_device(device)
    A, b = A.to(dev), b.to(dev)
    mask = _checked_mask(straggler_mask, q, dev)
    workers = _local_workers(q, group)
    keys = prng.worker_keys(key, q, round_id)[workers.start : workers.stop]
    A = A.T.contiguous().T  # a view whose transpose is contiguous: no copy per worker
    xs = torch.stack([solve.sketch_least_norm(spec, k, A, b) for k in keys])
    return _average(xs, mask, workers, group, on_empty)


def distributed_sketch_solve_multiround(
    spec: sk.SketchSpec,
    key: torch.Tensor,
    A: torch.Tensor,
    b: torch.Tensor,
    *,
    q: int,
    rounds: int,
    reg: float = 0.0,
    method: str = "fused",
    on_empty: str = "nan",
    latency=None,
    runtime_config=None,
    error_fn=None,
    device=None,
    group=None,
) -> torch.Tensor:
    """Elastic scaling in time, synchronous form: ``rounds`` successive waves of q
    workers, every output averaged (effective q = rounds · q). Wave r is
    :func:`distributed_sketch_solve` with ``round_id=r`` (worker w of wave r uses
    ``prng.worker_key(key, w, r)``, the reference's key), and the waves' x̄ are
    averaged as they come: acc ← acc + (x̄_r − acc)/(r + 1), the reference's
    running mean. With ``rounds=1`` it is ``distributed_sketch_solve`` bitwise.
    ``group``: each wave's workers shared by its ranks, as for
    :func:`distributed_sketch_solve`; every rank returns the same x̄.

    Asynchronous mode: pass a :class:`repro_torch.runtime.LatencyModel` as
    ``latency`` (optionally a :class:`repro_torch.runtime.RuntimeConfig` and an
    ``error_fn``: ``"theory"`` / ``"probe"`` / callable) and the call becomes a
    thin wrapper over :func:`repro_torch.runtime.serverless_sketch_solve`: the
    same (worker, round) key grid, but arrival-ordered streaming averaging,
    deadlines, retries and early stopping instead of the synchronous wave
    barrier. It returns the engine's x̄ (float64 on the host) as a tensor of A's
    dtype on the device.
    """
    if rounds < 1:
        raise ValueError(f"rounds must be at least 1, got {rounds}")
    if latency is not None:
        if group is not None:
            raise ValueError("the asynchronous mode runs on the serverless runtime, not on a process group")
        from repro_torch import runtime as rt

        dev = resolve_device(device)
        res = rt.serverless_sketch_solve(spec, key, A, b, q=q, rounds=rounds, latency=latency,
                                         config=runtime_config, reg=reg, method=method, error_fn=error_fn,
                                         device=dev)
        return torch.as_tensor(res.xbar, dtype=A.dtype).to(dev)
    acc = None
    for r in range(rounds):
        xbar_r = distributed_sketch_solve(spec, key, A, b, q=q, round_id=r, reg=reg, method=method,
                                          on_empty=on_empty, device=device, group=group)
        acc = xbar_r if acc is None else acc + (xbar_r - acc) / (r + 1.0)
    return acc
