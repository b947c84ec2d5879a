"""Rank bodies and shared inputs for ``tests/test_torch_process_group.py``.

Kept apart from the test module so that a spawned rank imports only torch and
the port, never JAX. The inputs are numpy arrays drawn from fixed seeds, made
the same way by the ranks, by the test process and by the JAX subprocess that
runs the reference on a 4-device mesh.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

N, D, M, Q = 512, 6, 40, 8        # least squares: q = 8 workers over 2 or 4 ranks
LN_N, LN_D, LN_M = 12, 64, 24     # the §V least-norm problem (n < d)
SJLT_S = 4
SEED = 7                          # the base key: jax.random.PRNGKey(7), words (0, 7)
MASK = np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32)
EMPTY = np.zeros(Q, np.float32)
ROUNDS = 2
GRAD_SHAPES = {"w": (1500,), "b": (40, 8)}  # D = 1,820 coordinates
# Each rank's straggler flag for the masked gradient mean.
RANK_MASK = {1: [1.0], 2: [1.0, 0.0], 4: [1.0, 0.0, 1.0, 1.0]}
# GradCompressionConfig arguments of the compressed means.
COMP_CFGS = {
    "off": dict(enabled=False),
    "same_countsketch": dict(enabled=True, ratio=0.1),
    "same_gaussian": dict(enabled=True, ratio=0.1, kind="gaussian"),
    "fresh_countsketch": dict(enabled=True, ratio=0.1, mode="fresh_sketch"),
}
MASKED_CFGS = {"off": dict(enabled=False), "countsketch": dict(enabled=True, ratio=0.1)}
# The solves each rank runs through the group (and rank 0 once more without one).
PATHS = ("worker", "worker_masked", "master", "master_qr", "least_norm", "multiround", "row_sharded")


def problem():
    """(A, b) of the least-squares paths and (A_ln, b_ln) of the least-norm path."""
    rs = np.random.default_rng(11)
    A = rs.standard_normal((N, D)).astype(np.float32)
    b = (A @ rs.standard_normal(D) + 0.1 * rs.standard_normal(N)).astype(np.float32)
    A_ln = rs.standard_normal((LN_N, LN_D)).astype(np.float32)
    b_ln = rs.standard_normal(LN_N).astype(np.float32)
    return A, b, A_ln, b_ln


def worker_outputs():
    """A (q, d) stack of workers' x̂ for the averaging checks."""
    return np.random.default_rng(12).standard_normal((Q, D)).astype(np.float32)


def grads(rank: int) -> dict:
    """Rank ``rank``'s gradient tree (numpy float32 leaves)."""
    rs = np.random.default_rng(100 + rank)
    return {k: rs.standard_normal(shape).astype(np.float32) for k, shape in GRAD_SHAPES.items()}


def _solve(path: str, group, rank: int, world: int):
    """One path's x̄ through ``group`` (None: one process with all the rows)."""
    import torch

    from repro_torch.core import distributed as tdist, sketches as tsk
    from repro_torch.utils import prng

    A, b, A_ln, b_ln = (torch.from_numpy(a) for a in problem())
    key = prng.prng_key(SEED)
    gauss = tsk.SketchSpec("gaussian", M)
    common = dict(q=Q, device="cpu", group=group)
    if path == "worker":
        return tdist.distributed_sketch_solve(gauss, key, A, b, **common)
    if path == "worker_masked":
        return tdist.distributed_sketch_solve(tsk.SketchSpec("sjlt", M, s=SJLT_S), key, A, b, round_id=3,
                                              straggler_mask=MASK, **common)
    if path == "master":
        return tdist.distributed_sketch_solve_master(tsk.SketchSpec("rademacher", M), key, A, b,
                                                     straggler_mask=MASK, **common)
    if path == "master_qr":
        return tdist.distributed_sketch_solve_master(gauss, key, A, b, method="qr", **common)
    if path == "least_norm":
        return tdist.distributed_sketch_least_norm(tsk.SketchSpec("gaussian", LN_M), key, A_ln, b_ln,
                                                   straggler_mask=MASK, **common)
    if path == "multiround":
        return tdist.distributed_sketch_solve_multiround(gauss, key, A, b, rounds=ROUNDS, **common)
    if path == "row_sharded":
        rows = slice(None) if group is None else slice(rank * N // world, (rank + 1) * N // world)
        return tdist.distributed_sketch_solve(tsk.SketchSpec("uniform", M), key, A[rows], b[rows], row_sharded=True,
                                              **common)
    raise ValueError(path)


def _compressed(cfgs: dict, group, rank: int, masked: bool) -> dict:
    import torch

    from repro_torch.core import gradcomp
    from repro_torch.train import sketch_dp
    from repro_torch.utils import prng

    g = {k: torch.from_numpy(v) for k, v in grads(rank).items()}
    key = prng.prng_key(SEED)
    world = 1 if group is None else group.size()
    out = {}
    for name, kw in cfgs.items():
        cfg = gradcomp.GradCompressionConfig(**kw)
        if masked:
            res = sketch_dp.masked_compressed_mean(cfg, key, g, RANK_MASK[world][rank], group)
        else:
            res = gradcomp.compressed_psum_mean(cfg, key, g, group)
        for leaf, v in res.items():
            out[f"{'masked' if masked else 'comp'}_{name}_{leaf}"] = v.numpy()
    return out


def run_rank(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """One rank: psum_average, every path through the group, the compressed
    means, and each path once more through this rank's group of one (with the
    one-process x̄ beside it, computed here so both come from one process)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import averaging
    from repro_torch.launch import mesh

    torch.set_num_threads(1)
    group, _ = mesh.init_worker_group(device="cpu", rank=rank, world_size=world, init_method=f"file://{init_file}")
    res = {"worker_index": np.int64(averaging.worker_index(group))}
    xs = torch.from_numpy(worker_outputs())
    per = Q // world
    local = slice(rank * per, (rank + 1) * per)
    res["psum_masked"] = averaging.psum_average(xs[local], torch.from_numpy(MASK[local]), group).numpy()
    for on_empty in ("nan", "zero"):
        res[f"psum_empty_{on_empty}"] = averaging.psum_average(
            xs[local], torch.from_numpy(EMPTY[local]), group, on_empty=on_empty).numpy()
    for path in PATHS:
        res[f"group_{path}"] = _solve(path, group, rank, world).numpy()
    res.update(_compressed(COMP_CFGS, group, rank, masked=False))
    res.update(_compressed(MASKED_CFGS, group, rank, masked=True))
    singles = [dist.new_group([r]) for r in range(world)]  # every rank takes part in each new_group
    for path in ("worker", "master", "least_norm"):
        res[f"one_{path}"] = _solve(path, singles[rank], 0, 1).numpy()
        res[f"none_{path}"] = _solve(path, None, 0, 1).numpy()
    if rank == 0:
        for path in PATHS:
            res[f"none_all_{path}"] = _solve(path, None, 0, 1).numpy()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    dist.destroy_process_group()
