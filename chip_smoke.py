#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source,
in parallel), checks the device counter RNG against the plain PyTorch contract
and the dense S·A kernel's tensor-core product (one warp's 3xTF32 m16n8k8, the
clusters the card holds for it and for each dense Gram, a launch path that
does not wait for the card, one traced call at FIG4A's shape), holds each
sketch→Gram kernel (Gaussian, Rademacher and SRHT on one tensor-core pass,
SJLT with FIG3A's s = 20) against its plain version at the FIG3A shape (n = 500,000, d = 250,
m = 2,500), q = 1 and 2, and each S·A kernel (Gaussian, Rademacher, SJLT) and
the FWHT kernel at the shapes of their paths (the hybrid's m′ = 25,000 rows, the
two-pass path's full n; the FWHT and the fused SRHT forward on 2^19 and 2^15
rows, the forward beside the composition it replaced: D·A, zero rows, the full
FWHT, the gather), then runs Algorithm 1 end to end:

* Gaussian: master-sketch mode at q = 200 (twice, bitwise equal; once more
  traced), worker-side mode at q = 8;
* Rademacher: both modes at q = 8;
* SRHT and SJLT: master-sketch mode at q = 200 (twice, bitwise equal; the SJLT
  once more traced), worker-side mode at q = 8; the SRHT's host-side row draw
  is timed alone;
* the hybrid (m′ = 25,000 uniformly sampled rows, then the inner sketch): with
  the SJLT inside in master-sketch mode at q = 200 (once more traced), with the Gaussian,
  Rademacher and SRHT inside in worker-side mode at q = 8;
* uniform sampling without replacement in master-sketch mode at q = 200;
* the two-pass reference (``method="qr"``) in master-sketch mode at q = 8 for
  the Gaussian, Rademacher, SRHT and SJLT, each held against its fused x̄;
* leverage-score sampling in worker-side mode at q = 2, its row draw timed.

Then the §V right-sketch least-norm path (``distributed_sketch_least_norm``,
n < d), whose Gaussian workers keep the S their forward S·Aᵀ draws and read it
back in the adjoint: both Gaussian adjoint kernels (over the kept S, and with S
drawn again) against their plain version and each other at the shapes the
paths give them, with the library's product on the same S; each S·A kernel at
X = Aᵀ and on the hybrid's m′ rows of it (the Gaussian's also with and without
the store of S); the FWHT and the fused SRHT forward on the SRHT's forward
shapes, the FWHT on its adjoint's (one and 33 columns); then the paths, each
twice and bitwise equal: FIG4A (n = 50, d = 1,000, m = 200, m′ = 500) and the
Fig. 4(b) shape (n = 2,000, d = 11,556, m = 4,000, m′ = 8,000) at q = 100 with
the Gaussian, uniform sampling without
replacement and the hybrid with the Gaussian inside (the paper's Fig. 4
sketches); every kind at FIG4A, q = 8, each kind with a kernel also with
``use_kernel=False`` against the kernel path's x̄, and the Gaussian once more
with a scratch too small to keep S (the redraw kernel). Each is gated on
‖x̄ − x*‖²/‖x*‖² over Lemma 7's (d − n)/(q(m − n − 1)), x* from a plain
float64 solve.

Then the serverless runtime and the solve server (``repro_torch.runtime``,
``repro_torch.serve``), on FIG3A's Gaussian data: one SJLT job at q = 200 under a
Pareto latency tail with retries on the inline, thread (8 threads) and process
(2 spawned workers) backends, which must give one event log byte for byte and one
x̄ bitwise, each arrival one ``sjlt_gram`` call (a traced thread run gives the
device's idle share); two Gaussian jobs of one seed through ``SolveServer``
(drops, adaptive deadlines, the probe error), their x̄ held within 1e-6 against
the synchronous solves of the same arrivals (the master's multi-key Gram over the
realized mask, each retried arrival alone); a job that stops at q′ = 100 on
Theorem 1; a least-norm job at FIG4A (q = 100) on Lemma 7; the asynchronous
multi-round mode (4 × 50, the engine's x̄ bitwise); a process-backend worker
killed at one (worker, round), which must show as a drop and a fresh-round retry;
and ``python -m repro_torch.launch.serve --solve`` as a subprocess.

Between the least-norm and the serverless phases, gradient compression and head
fitting: sketched gradient compression at ``benchmarks/gradcomp_bench.py``'s full
size (D = 2^20 + 2^16): CountSketch at ratios 0.01-0.25 through row 12b
(``repro_sjlt_apply_long``, the SJLT S·A of few, long columns), its payload
against the plain version per bucket and its error² against (D − 1)/m, the
Gaussian at 1% through rows 6 and 5b, the fresh-sketch mean of q = 1, 4, 16;
row 12b at D = 2^28 and ratios 0.01, 0.1 and 0.25 against its bound and the
library's ``index_add_``, with the whole compress + decompress and its peak
memory; in both, decompress's adjoint over the pair list the compress kept
beside the adjoint that draws the pairs again, bitwise (row 12b's device time by
pass: ``tools/sjlt_long_profile.py``); and
``train.solvers.fit_head`` at whisper-small's width (262,144 × 768 features, 16
outputs, q = 16, 12 arriving) through rows 2 and 11, on Theorem 1. After the
serverless phases, Algorithm 1 across processes: FIG3A in worker mode at q = 8
with each worker sketching only its own 62,500 rows of A and b
(``row_sharded=True``; Gaussian, SRHT and SJLT, one fused single-key Gram a
worker, twice, bitwise, gated on bands from the reference's local-block
ratios); worker, master and least-norm solves and the masked gradient mean
(compression off and on, a scalar mask) through
``launch.mesh.init_worker_group``'s NCCL group of one rank in this process,
each result bitwise the one without a group; and two spawned ranks in a gloo group,
both on the card, running the replicated and row-sharded worker mode (4
workers a rank) and the masked, compressed gradient mean, each within 1e-6 of
the one-process result and bitwise on a rerun.

The SJLT rows carry their plan (splits, m-tiles, column tiles, blocks,
workers a call) and the scatter's shared-memory floor beside the bound; the SJLT
S·A at each shape also its device time under ``torch.profiler``, which splits
the event time into kernel time and launch path.

The row-offset S·A calls are timed beside the library on the same tile (one
``torch.matmul`` over the pre-drawn S tile, one ``index_add_`` of the signed rows).

Each new path runs twice, bitwise equal. Each path runs with the launch counts
at 0 and must make exactly the calls into the kernels' C entries that its
worker chunks call for, and no other. The multi-key Grams and S·A of the main
path are held, at the edges of their worker chunks, against single-key calls
(bitwise) and the plain version. Each phase prints one JSON line; any failed
check exits non-zero. The second-to-last line is the kernels summary; the last
line is ``{"ok": true, "device": {...}}``.

Float32 matrix products run in true float32 (TF32 off) throughout.
It imports nothing of JAX or of the JAX package, and exits non-zero when CUDA is
unavailable or when run outside a checkout of the repository.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parent
SEED = 20260
# Kernel against plain, per entry: max |ΔG_ij| / sqrt(G_ii·G_jj) over the plain G.
# Both sum 5e5 float32 products per S·X entry and 2,500 per G entry, in two orders.
GRAM_TOL = 1e-5
NORMAL_ABS_TOL = 2e-6  # device logf/cosf vs the plain version: a few float32 ulps at |z| ≤ 6.7
THEORY_FACTOR = 3.0  # rel_err must lie within [pred/3, 3·pred] of Theorem 1
# Theorem 1 is exact for the Gaussian only. With the JAX reference on the CPU, at
# cuts of FIG3A on the same planted data (tests/theory_ratio.py; PERF.md §6),
# rel_err / Theorem 1 was: SRHT and SJLT (s = 20) 0.70-1.35 and 0.67-1.35 (d = 25,
# q = 200, 4 seeds), 0.75-1.12 and 0.73-1.10 (d = 100, 6 seeds), the Gaussian
# 0.72-1.35 and 0.79-1.23; uniform sampling without replacement 0.84-1.37 (d = 25,
# q = 200) and 0.71-1.43 (q = 8, 8 seeds); leverage sampling 0.77-1.25 (q = 8) and
# 0.67-1.39 (q = 2); the hybrid (m′ = 10·m) with the Gaussian, Rademacher, SJLT
# and SRHT inside 0.87-1.43, 1.11-1.29, 0.62-1.08 and 0.75-1.26 (q = 200) and
# 1.03-1.70, 0.81-1.85, 0.61-1.60 and 0.85-1.83 (q = 8). The spread is that of a
# chi-square of d degrees of freedom, √(2/d): 28% at d = 25, 9% at FIG3A's d = 250.
# Their gate is the band [1/2, 2].
THEORY_BAND = {kind: (0.5, 2.0) for kind in (
    "srht", "sjlt", "uniform", "leverage", "hybrid_gaussian", "hybrid_rademacher", "hybrid_sjlt",
    "hybrid_srht")}
# S·A kernel against plain, per column: max_i |ΔSX_ij| / rms_i(SX_ij) over the plain S·X.
SX_TOL = 1e-5
# Two-pass (qr) x̄ against the fused x̄ of the same sketches: max |Δx| / max |x|.
# Both solve a problem of condition ≈ 2 (m = 10·d) in float32.
QR_FUSED_TOL = 1e-4
CHECK_Q = 2  # workers in the kernel-against-plain phase
SIDE_Q = 8  # workers in the worker-side and Rademacher phases
SJLT_S = 20  # FIG3A's nonzeros per data row (RegressionConfig.s)

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): 67 TFLOP/s float32 outside the
# tensor cores, 3.35 TB/s HBM. INT32: 64 lanes per SM (half the 128 FP32 lanes,
# Hopper white paper) at the same clock, so 67/4 = 16.7 T integer ops/s.
PEAK_FP32_FLOPS = 67e12
# Dense TF32 on the tensor cores (same data sheet). The dense S·A and Gram kernels'
# products are fp32-accurate in 3xTF32 form: 3 TF32 products per Gaussian flop
# pair, 2 for the ±1 signs of the Rademacher and the SRHT (exact in TF32, scaled
# after the sum).
PEAK_TF32_FLOPS = 495e12
TF32_PASSES = {"gaussian": 3, "rademacher": 2, "srht": 2}
PEAK_INT32_OPS = 16.7e12
PEAK_BYTES = 3.35e12
# Shared memory: one 128-byte wavefront a cycle on each of 132 SMs at the
# 1,980 MHz boost clock (nvidia-smi's clocks.max.sm on an H100 SXM). The SJLT
# scatter's floor: each (pair, 32 columns) reads and writes an accumulator row
# and reads the X row, 3 wavefronts.
SMEM_WAVEFRONTS_PER_S = 132 * 1.98e9
LEVERAGE_Q = 2  # workers of the leverage path: each draws an (m, n) gumbel array
# Least-norm paths: ‖x̄ − x*‖²/‖x*‖² over Lemma 7 / q, x* the float64 least-norm
# solution. With the JAX reference on the CPU (tests/theory_ratio.py --least-norm,
# A and b Gaussian; PERF.md §6, PR 14) the ratio was: Gaussian 0.89-1.09 (FIG4A,
# q = 100, 8 seeds), 0.90-1.13 (q = 8, 16 seeds), 0.98-1.04 (n = 500, d = 2,862,
# m = 1,000, m′ = 2,000, q = 100, 4 seeds); uniform without replacement 0.79-1.00,
# 0.71-0.97, 0.78-0.85; the hybrid (Gaussian inside) 1.11-1.20, 1.05-1.39, 1.12-1.16;
# at q = 8 Rademacher 0.92-1.11, SRHT 0.98-1.13, SJLT (s = 20) 0.92-1.15, uniform with
# replacement 0.91-1.23, leverage 0.88-1.19, hybrids with the Rademacher, SJLT and SRHT
# inside 1.07-1.42, 1.08-1.34, 1.12-1.46. The spread is that of d − n ≥ 950 degrees of
# freedom. Lemma 7 is exact for the Gaussian only: its band is [0.8, 1.25], every
# other kind's [1/2, 2].
LN_BAND = {"gaussian": (0.8, 1.25)}
LN_OTHER_BAND = (0.5, 2.0)
LN_Q_SIDE = 8  # workers of the other kinds' least-norm paths
LN_FIG4B = {"n": 2000, "d": 107 + 107**2, "m": 4000, "m_prime": 8000, "q": 100}
# A use_kernel=False least-norm x̄ against the kernel path's x̄ of the same keys:
# max |Δx| / max |x|. Both draw the same S (Gaussian normals differ by float32 ulps,
# device and torch log/cos) and sum in other orders, and the n×n solve has
# condition ≈ (1 + √(n/m))²/(1 − √(n/m))² ≤ 6.
LN_PLAIN_TOL = 1e-4
DEVICE = "cuda"  # where every phase puts its data and runs the entry points


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def threefry_ops(rounds: int) -> int:
    """Integer operations of one threefry2x32: add/rotate/xor per round, 2 key adds
    up front, 3 adds per key injection."""
    return 3 * rounds + 2 + 3 * (rounds // 4)


def bound_ms(family: str, n: int, dx: int, m: int, q: int, rounds: int = 20,
             s: int = SJLT_S, apply: bool = False) -> tuple[float, str]:
    """Least time the card could take for q fused Grams of X (n, dx), or with
    ``apply`` for q sketches S·X: the larger of the bytes (X read once, each G or
    S·X written once) over HBM rate and each operation type over its peak: fp32
    FFMA for S·X and the Gram; int32 for drawing S.

    Dense families do 2·m·n·dx FFMA flops per worker. Integer work per S entry:
    Gaussian one threefry; Rademacher 1/32 of one; SRHT an AND, a popcount and a
    select (3) plus one threefry per data row for the diagonal. The SJLT does
    2·n·s·dx flops (s nonzeros per data row) and one threefry, a remainder and a
    sign per (row, t) pair."""
    out_floats = q * (m * dx if apply else dx * dx)
    bytes_ms = 4 * (n * dx + out_floats) / PEAK_BYTES * 1e3
    gram_flops = 0 if apply else 2 * m * dx * dx * q
    if family == "sjlt":
        flops = 2 * n * s * dx * q + gram_flops
        int_ops = n * s * q * (threefry_ops(20) + 2)
    else:
        flops = 2 * m * n * dx * q + gram_flops
        per_entry = {"gaussian": threefry_ops(rounds), "rademacher": threefry_ops(20) / 32,
                     "srht": 3}[family]
        int_ops = m * n * q * per_entry + (n * q * threefry_ops(20) if family == "srht" else 0)
    fp_ms = flops / PEAK_FP32_FLOPS * 1e3
    int_ms = int_ops / PEAK_INT32_OPS * 1e3
    ops_ms = max(fp_ms, int_ms)
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def apply_bound(family: str, n: int, dx: int, m: int, q: int, rounds: int = 20) -> dict:
    """The bound of q sketches S·X (n, dx): for the dense families on the tensor
    cores (``bound_ms``: the bytes, the TF32 passes of 2·m·n·dx·q flops at the TF32
    peak, and the RNG at the int32 rate) with the FFMA bound of the same work
    beside it (``ffma_bound_ms``, as earlier rows were bound); the SJLT's as
    :func:`bound_ms`, with its scatter's shared-memory floor beside it."""
    ffma_ms, ffma_by = bound_ms(family, n, dx, m, q, rounds, apply=True)
    if family not in TF32_PASSES:
        return {"bound_ms": ffma_ms, "bound_by": ffma_by, "ffma_bound_ms": ffma_ms,
                "smem_floor_ms": sjlt_smem_floor_ms(n, dx, q)}
    bytes_ms = 4 * (n * dx + q * m * dx) / PEAK_BYTES * 1e3
    tensor_ms = TF32_PASSES[family] * 2 * m * n * dx * q / PEAK_TF32_FLOPS * 1e3
    per_entry = threefry_ops(rounds) if family == "gaussian" else threefry_ops(20) / 32
    int_ms = m * n * q * per_entry / PEAK_INT32_OPS * 1e3
    ops_ms = max(tensor_ms, int_ms)
    by = "bytes" if bytes_ms > ops_ms else "operations"
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": by, "ffma_bound_ms": ffma_ms,
            "tensor_ms": tensor_ms, "rng_ms": int_ms}


def gram_bound(family: str, n: int, dx: int, m: int, q: int, rounds: int = 20) -> dict:
    """The bound of q fused Grams of X (n, dx): for the dense families, whose
    sketch pass runs on the tensor cores, the larger of the bytes, the TF32 passes
    of 2·m·n·dx·q flops at the TF32 peak (plus the Gram pass's 2·m·dx²·q FFMA flops
    at the fp32 peak, a kernel of its own) and the RNG at the int32 rate, with the
    FFMA bound of the same work beside it (``ffma_bound_ms``); the SJLT's as
    :func:`bound_ms`, with its scatter's shared-memory floor beside it. Integer work: a threefry per Gaussian entry; one per 32
    Rademacher entries (a packed sign word); for the SRHT an AND, a popcount and an
    XOR per 32 entries (a sign word: the closed form's parity splits into the
    step's and the row's low bits) and a threefry per data row for the diagonal."""
    ffma_ms, ffma_by = bound_ms(family, n, dx, m, q, rounds)
    if family not in TF32_PASSES:
        return {"bound_ms": ffma_ms, "bound_by": ffma_by, "ffma_bound_ms": ffma_ms,
                "smem_floor_ms": sjlt_smem_floor_ms(n, dx, q)}
    bytes_ms = 4 * (n * dx + q * dx * dx) / PEAK_BYTES * 1e3
    tensor_ms = (TF32_PASSES[family] * 2 * m * n * dx * q / PEAK_TF32_FLOPS
                 + 2 * m * dx * dx * q / PEAK_FP32_FLOPS) * 1e3
    per_entry = {"gaussian": threefry_ops(rounds), "rademacher": threefry_ops(20) / 32, "srht": 3 / 32}[family]
    int_ops = m * n * q * per_entry + (n * q * threefry_ops(20) if family == "srht" else 0)
    int_ms = int_ops / PEAK_INT32_OPS * 1e3
    ops_ms = max(tensor_ms, int_ms)
    by = "bytes" if bytes_ms > ops_ms else "operations"
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": by, "ffma_bound_ms": ffma_ms,
            "tensor_ms": tensor_ms, "rng_ms": int_ms}


def sjlt_smem_floor_ms(n: int, dx: int, q: int, s: int = SJLT_S) -> float:
    """The SJLT scatter's shared-memory floor for q sketches of X (n, dx): 3
    wavefronts per pair and 32 columns (module note at SMEM_WAVEFRONTS_PER_S)."""
    return 3 * n * s * dx * q / 32 / SMEM_WAVEFRONTS_PER_S * 1e3


def sjlt_plan(n: int, dx: int, m: int) -> dict:
    """The SJLT passes' plan at this shape: splits, m-tiles, column tiles,
    scatter blocks and workers a call."""
    from repro_torch.kernels import cuda

    p = cuda.plan_sjlt(n, m, dx, SJLT_S)
    return {"plan": {"splits": p.n_splits, "m_tiles": p.m_tiles, "column_tiles": p.d_tiles,
                     "chunk_rows": p.chunk_rows, "blocks": p.blocks,
                     "workers_per_call": cuda.worker_chunk(n, m, dx, 1 << 20, family="sjlt", s=SJLT_S)}}


def gram_plan(family: str, n: int, dx: int, m: int) -> dict:
    """The launch plan of a Gram kernel at this shape: the one plan of the dense
    Gaussian, Rademacher and SRHT, or the SJLT's (:func:`sjlt_plan`)."""
    from repro_torch.kernels import cuda

    if family == "sjlt":
        return sjlt_plan(n, dx, m)
    p = cuda.plan_dense_gram(n, m, dx)
    return {"plan": {"splits": p.n_splits, "block_cols": p.block_cols, "cluster": p.cluster,
                     "clusters": p.clusters, "blocks": p.blocks,
                     "workers_per_call": cuda.worker_chunk(n, m, dx, 1 << 20, family=family)}}


def apply_plan(family: str, n: int, dx: int, m: int) -> dict:
    """The launch plan of an S·A kernel at this shape (the SJLT's: :func:`sjlt_plan`)."""
    from repro_torch.kernels import cuda

    if family == "sjlt":
        return sjlt_plan(n, dx, m)
    p = cuda.plan_apply(n, m, dx)
    return {"plan": {"splits": p.n_splits, "block_cols": p.block_cols, "cluster": p.cluster,
                     "groups": p.groups, "blocks": p.blocks, "direct": p.direct}}


def fwht_bound_ms(n: int, k: int) -> tuple[float, str]:
    """Least time for H·x, x (n, k) float32: x read once and H·x written once, or
    the log2(n) stages of one add or subtract per element each, at the fp32 peak."""
    bytes_ms = 8 * n * k / PEAK_BYTES * 1e3
    ops_ms = n * k * (n.bit_length() - 1) / PEAK_FP32_FLOPS * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def srht_forward_bound_ms(n: int, k: int, m: int, n_pad: int) -> tuple[float, str]:
    """Least time for the SRHT's S·A, A (n, k) float32, m sampled rows of the
    n_pad-point transform: A and the m ids read once and the (m, k) output
    written once, or the operations: the log2(n_pad) stages of one add or
    subtract per element of the padding at the fp32 peak, one threefry a row of
    A (its sign) at the int32 rate."""
    bytes_ms = 4 * (n * k + m + m * k) / PEAK_BYTES * 1e3
    ops_ms = max(n_pad * k * (n_pad.bit_length() - 1) / PEAK_FP32_FLOPS, n * threefry_ops(20) / PEAK_INT32_OPS) * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def srht_forward_floor_ms(n: int, k: int, m: int, n_pad: int) -> float:
    """The bytes of the fused SRHT forward's own plan (``cuda.plan_fwht``) at
    3.35 TB/s: A read once, each pass but the last writing the rows it can make
    nonzero (n up to whole spans of the stages so far) and the next reading
    them, the m rows written."""
    from repro_torch.kernels import cuda

    rows, done = 0, 0
    for t in cuda.plan_fwht(n_pad)[:-1]:
        done += t
        rows += -(-n // (1 << done)) * (1 << done)
    return 4 * (n * k + 2 * rows * k + m + m * k) / PEAK_BYTES * 1e3


def adjoint_bound_ms(m: int, n: int, k: int, rounds: int = 20) -> tuple[float, str]:
    """Least time for Sᵀ·Y, Y (m, k) float32, S (m, n) Gaussian drawn in-core: Y read
    once and the (n, k) output written once, or the operations: one threefry per S
    entry at the int32 rate and 2·m·n·k FFMA flops at the fp32 rate."""
    bytes_ms = 4 * (m * k + n * k) / PEAK_BYTES * 1e3
    ops_ms = max(m * n * threefry_ops(rounds) / PEAK_INT32_OPS, 2 * m * n * k / PEAK_FP32_FLOPS) * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def cuda_ms(fn, reps: int, *, warmup: bool = True):
    """(mean device time of ``fn()`` over ``reps`` runs, the last run's result),
    after one warm-up run unless ``warmup`` is False (CUDA events)."""
    import torch

    if warmup:
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs under ``torch.profiler``:
    the time the card spends in its kernels and copies, without the launch path
    or the gaps between them (after one warm-up run)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA) / 1e3 / reps


def gram_err(G, want) -> float:
    """max |G_ij − want_ij| / sqrt(want_ii·want_jj) over a stack of Grams."""
    import torch

    G, want = G.double().reshape(-1, *G.shape[-2:]), want.double().reshape(-1, *want.shape[-2:])
    diag = torch.diagonal(want, dim1=-2, dim2=-1).clamp_min(0)
    return float(((G - want).abs() / (diag[:, :, None] * diag[:, None, :]).sqrt()).max())


def host_s(fn):
    """(result, seconds) of ``fn()`` ended by a device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_build():
    from repro_torch.kernels import cuda

    t0 = time.perf_counter()
    built = cuda.build()
    seconds = time.perf_counter() - t0
    emit({"phase": "build", "seconds": seconds,
          "libraries": {b.name: b.seconds for b in built},
          "ptxas": {b.name: cuda.ptxas_usage(b.log) for b in built if b.log}})


def phase_tensor_cores() -> None:
    """The tensor-core kernels' building blocks before their paths: one warp's m16n8k8
    TF32 product (fragment layouts; the 3xTF32 form within 1e-6 of a float64
    product, relative to its largest entry), the clusters the card holds at each
    column width (dense S·A; each dense Gram family), the rate of ``mma.sync`` TF32 alone (a register-only
    loop: the ceiling of the S·A's consumers), the wrappers that copy key words to the card
    (the dense S·A with one key and three, keeping its S or not, the multi-key dense
    Grams, the SJLT S·A) and the kept-S adjoint at
    FIG4A's shape under ``torch.cuda.set_sync_debug_mode("error")`` (none may
    wait for the card), and one traced single-key Gaussian S·A there (host
    enqueue against device time)."""
    import numpy as np
    import torch

    from repro_torch.configs.paper_lsq import FIG4A
    from repro_torch.core import operators, sketches as sk
    from repro_torch.kernels import cuda
    from repro_torch.kernels.fwht import ops as fops
    from repro_torch.kernels.gaussian import ops
    from repro_torch.kernels.rademacher import ops as rops
    from repro_torch.kernels.sjlt import ops as sops
    from repro_torch.utils import prng

    rs = np.random.default_rng(SEED + 11)
    A = torch.from_numpy(rs.standard_normal((16, 8)).astype(np.float32))
    B = torch.from_numpy(rs.standard_normal((8, 8)).astype(np.float32))
    d1, d3 = cuda.mma_probe(A.to(DEVICE), B.to(DEVICE))
    want = A.double() @ B.double()
    scale = float(want.abs().max())
    err3 = float((d3.cpu().double() - want).abs().max()) / scale
    err1 = float((d1.cpu().double() - want).abs().max()) / scale
    clusters = {bn: cuda.apply_clusters(bn, cuda.APPLY_MAX_CLUSTER) for bn in cuda.APPLY_BLOCK_COLS}
    gram_clusters = {f"{family}_{bn}": cuda.gram_clusters(bn, cuda.GRAM_MAX_CLUSTER, family)
                     for family in cuda.DENSE_GRAMS for bn in cuda.GRAM_BLOCK_COLS}
    X = torch.from_numpy(rs.standard_normal((FIG4A.d, FIG4A.n)).astype(np.float32)).to(DEVICE)
    key = prng.worker_key(prng.prng_key(SEED + 11), 0)
    keys = prng.worker_keys(prng.prng_key(SEED + 12), 3)
    m = FIG4A.m
    kd, srht_rows = operators.srht_params(keys, m, sk.next_pow2(X.shape[0]))
    S_kept = ops.gaussian_sketch_keep(key, X, m)[1]
    Yk = torch.from_numpy(rs.standard_normal((m, 1)).astype(np.float32)).to(DEVICE)
    wrappers = {  # each copies its key words (and the SRHT its row ids) to the card, but the kept adjoint
        "gaussian_sketch": lambda: ops.gaussian_sketch(key, X, m),
        "gaussian_sketch_keep": lambda: ops.gaussian_sketch_keep(key, X, m)[1][:, :X.shape[0]],
        "gaussian_adjoint_kept": lambda: ops.gaussian_adjoint_kept(S_kept, Yk, X.shape[0]),
        "gaussian_sketch_multi": lambda: ops.gaussian_sketch_multi(keys, X, m),
        "rademacher_sketch_multi": lambda: rops.rademacher_sketch_multi(keys, X, m),
        "gaussian_gram_multi": lambda: ops.gaussian_gram_multi(keys, X, m),
        "rademacher_gram_multi": lambda: rops.rademacher_gram_multi(keys, X, m),
        "srht_gram_multi": lambda: fops.srht_gram_multi(kd, srht_rows, X),
        "sjlt_apply_multi": lambda: sops.sjlt_apply_multi(keys, X, m, SJLT_S),
    }
    no_sync = {}
    for label, fn in wrappers.items():
        want = fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fn()
        except RuntimeError:
            got = None
        finally:
            torch.cuda.set_sync_debug_mode("default")
        no_sync[label] = got is not None and bool(torch.equal(got, want))  # bitwise its first call, too
    run, flops = cuda.mma_rate(4 * 132, 2000)
    rate_ms, _ = cuda_ms(run, 3)
    emit({"phase": "tensor_cores", "mma_3xtf32_rel_err": err3, "mma_tf32_rel_err": err1,
          "clusters_of_8_resident": clusters, "gram_clusters_resident": gram_clusters,
          "gram_cluster": cuda.GRAM_MAX_CLUSTER, "no_sync_call": no_sync,
          "mma_sync_tf32_tflops": flops / rate_ms / 1e9, "peak_tf32_tflops": PEAK_TF32_FLOPS / 1e12})
    check(err3 <= 1e-6, f"3xTF32 mma probe off a float64 product by {err3}")
    check(err1 > 1e-5, f"one TF32 mma equals the 3xTF32 form ({err1}): the split is not applied")
    check(all(c > 0 for c in clusters.values()), f"a cluster of 8 does not fit the card: {clusters}")
    check(all(c > 0 for c in gram_clusters.values()), f"a Gram cluster does not fit the card: {gram_clusters}")
    check(all(no_sync.values()), f"a wrapper waited for the card or changed its result: {no_sync}")
    phase_trace("fig4a_gaussian_sketch_traced", lambda: ops.gaussian_sketch(key, X, FIG4A.m))


def phase_rng_probe():
    import numpy as np
    import torch

    from repro_torch.kernels import common, cuda
    from repro_torch.utils import prng

    rs = np.random.default_rng(SEED)
    edges = np.array([0, 1, 31, 32, 2**31 - 1, 2**31, 2**32 - 1], np.int64)
    c0 = torch.from_numpy(np.concatenate([edges, rs.integers(0, 2**32, 1 << 16)]).astype(np.int64))
    c1 = torch.from_numpy(np.concatenate([edges[::-1], rs.integers(0, 2**32, 1 << 16)]).astype(np.int64))
    k0, k1 = common.key_words(prng.worker_key(prng.prng_key(SEED), 3, 1))
    report = {"phase": "rng_probe", "counters": int(c0.numel())}
    for rounds in (20, 8):
        words, normals, signs = cuda.rng_probe(k0, k1, c0, c1, rounds=rounds)
        w0, w1 = common.threefry2x32(k0, k1, c0, c1, rounds=rounds)
        z = common.counter_normal(k0, k1, c0, c1, rounds=rounds)
        s = common.unpack_signs(common.packed_sign_words(k0, k1, c0, c1 // 32), c1 % 32)
        words_ok = torch.equal(words.cpu(), torch.stack([w0, w1], dim=1))
        signs_ok = torch.equal(signs.cpu(), s)
        z_err = float((normals.cpu() - z).abs().max())
        report[f"rounds{rounds}"] = {"words_bitwise": words_ok, "signs_bitwise": signs_ok,
                                     "normal_max_abs_err": z_err, "normal_tol": NORMAL_ABS_TOL}
        check(words_ok, f"device threefry words differ from the plain version ({rounds} rounds)")
        check(signs_ok, f"device packed signs differ from the plain version ({rounds} rounds)")
        check(z_err <= NORMAL_ABS_TOL, f"device normals off by {z_err} ({rounds} rounds)")
    emit(report)


FAMILY_ROUTES = {
    "gaussian": ("gaussian_gram", "gaussian_gram_multi",
                 "src/repro/kernels/gaussian/gram.py:28", "src/repro/kernels/gaussian/gram.py:82"),
    "rademacher": ("rademacher_gram", "rademacher_gram_multi",
                   "src/repro/kernels/rademacher/gram.py:34", "src/repro/kernels/rademacher/gram.py:81"),
    "srht": ("srht_gram", "srht_gram_multi",
             "src/repro/kernels/fwht/gram.py:29", "src/repro/kernels/fwht/gram.py:86"),
    "sjlt": ("sjlt_gram", "sjlt_gram_multi",
             "src/repro/kernels/sjlt/gram.py:24", "src/repro/kernels/sjlt/gram.py:80"),
}
SOURCES = {"gaussian": "sketch_gram.cu", "rademacher": "sketch_gram.cu", "srht": "sketch_gram.cu",
           "sjlt": "sjlt_gram.cu"}
APPLY_SOURCES = {"gaussian": "sketch_apply.cu", "rademacher": "sketch_apply.cu", "sjlt": "sjlt_gram.cu"}


def family_modules(family: str):
    if family == "gaussian":
        from repro_torch.kernels.gaussian import ops, ref
    elif family == "rademacher":
        from repro_torch.kernels.rademacher import ops, ref
    elif family == "srht":
        from repro_torch.kernels.fwht import ops, ref
    else:
        from repro_torch.kernels.sjlt import ops, ref
    return ops, ref


class Calls:
    """A family's kernel wrappers and plain versions on the sketches of the worker
    keys ``keys``, called as ``single(w, X)``, ``multi(X)``, ``plain_single(w, X)``
    and ``plain_multi(X)``. The SRHT's row ids are drawn here, before any timing;
    ``tile(w, j0, blk, device)`` is worker w's dense S tile (not for the SJLT)."""

    def __init__(self, family: str, keys, n: int, m: int):
        from repro_torch.core import operators, sketches as sk
        from repro_torch.kernels import common

        ops, ref = family_modules(family)
        single, multi, *_ = FAMILY_ROUTES[family]
        self.keys, self.m = keys, m
        if family == "srht":  # wrappers take (diagonal key words, row ids, X)
            kd, rows = operators.srht_params(keys, m, sk.next_pow2(n))
            head, mhead, tail = (lambda w: (kd[w], rows[w])), (kd, rows), ()
            self.tile = lambda w, j0, blk, dev: ref.columns(*common.key_words(kd[w]), rows[w], j0, blk, dev)
        else:  # wrappers take (key(s), X, m[, s])
            head, mhead = (lambda w: (keys[w],)), (keys,)
            tail = (m, SJLT_S) if family == "sjlt" else (m,)
            self.tile = lambda w, j0, blk, dev: ref.columns(*common.key_words(keys[w]), m, j0, blk, dev)
        self.single = lambda w, X: getattr(ops, single)(*head(w), X, *tail)
        self.multi = lambda X: getattr(ops, multi)(*mhead, X, *tail)
        self.plain_single = lambda w, X: getattr(ref, single)(*head(w), X, *tail)
        self.plain_multi = lambda X: getattr(ref, multi)(*mhead, X, *tail)


def dense_library(calls: Calls, X, q: int, gram: bool = True):
    """The yardstick of a dense family: each worker's S (m, n) materialized in
    float32 with the plain tiles, then one ``torch.matmul`` for S·X and (with
    ``gram``) one for the Gram. Returns ``run(k)``, which does that for the first
    k <= q workers; the port never calls it."""
    import torch

    from repro_torch.kernels import common

    n = X.shape[0]
    S = []
    for w in range(q):
        Sw = torch.empty((calls.m, n), dtype=torch.float32, device=X.device)
        for j0 in range(0, n, 8192):
            blk = min(8192, n - j0)
            Sw[:, j0 : j0 + blk] = calls.tile(w, j0, blk, X.device)
        S.append(Sw)

    def run(k):
        with common.full_fp32_matmul():
            return [sx.T @ sx if gram else sx for sx in (s @ X for s in S[:k])]

    return run


def sjlt_library(calls: Calls, X, q: int, gram: bool = True):
    """The SJLT's yardstick: per worker one ``index_add_`` of the pre-built signed,
    replicated rows (n·s, d) into (m, d) (atomics, so not deterministic), then
    (with ``gram``) one ``torch.matmul`` for the Gram. The parameters and the
    (n·s, d) source are made before any timing. Returns ``run(k)`` for the first
    k <= q workers; the port never calls it."""
    import torch

    from repro_torch.kernels import common

    n, dx = X.shape
    srcs = []
    for w in range(q):
        k0, k1 = common.key_words(calls.keys[w])
        rows = torch.arange(n, dtype=torch.int64, device=X.device)
        buckets, signs = common.sjlt_counter_params(k0, k1, rows, SJLT_S, calls.m)
        srcs.append((buckets.reshape(-1), (signs[..., None] * X[:, None, :]).reshape(n * SJLT_S, dx)))

    def run(k):
        out = []
        with common.full_fp32_matmul():
            for idx, src in srcs[:k]:
                acc = torch.zeros((calls.m, dx), dtype=torch.float32, device=X.device)
                acc.index_add_(0, idx, src)
                out.append(acc.T @ acc if gram else acc)
        return out

    return run


def phase_kernels(X, m: int, rows: dict) -> None:
    """Each kernel against its plain version at the main path's (n, d', m), q = 1, 2."""
    import torch

    from repro_torch.kernels import common
    from repro_torch.utils import prng

    n, dx = X.shape
    keys = prng.worker_keys(prng.prng_key(SEED + 1), CHECK_Q)
    for family, (single, multi, src_single, src_multi) in FAMILY_ROUTES.items():
        calls = Calls(family, keys, n, m)
        rounds = common.rng_rounds() if family == "gaussian" else common.DEFAULT_ROUNDS
        G_multi = calls.multi(X)
        G_single = [calls.single(w, X) for w in range(CHECK_Q)]
        bitwise = all(torch.equal(G_multi[w], G_single[w]) for w in range(CHECK_Q))
        rerun = torch.equal(calls.multi(X), G_multi)
        G_plain, plain_s = host_s(lambda: calls.plain_multi(X))
        abs_multi = float((G_multi - G_plain).abs().max())
        abs_single = float((G_single[0] - G_plain[0]).abs().max())
        err_multi, err_single = gram_err(G_multi, G_plain), gram_err(G_single[0], G_plain[0])
        _, plain_single_s = host_s(lambda: calls.plain_single(0, X))
        library = (sjlt_library if family == "sjlt" else dense_library)(calls, X, CHECK_Q)
        lib_single, _ = cuda_ms(lambda: library(1), 3)
        lib_multi, _ = cuda_ms(lambda: library(CHECK_Q), 3)
        del library
        torch.cuda.empty_cache()
        ms_single, _ = cuda_ms(lambda: calls.single(0, X), 3)
        ms_multi, _ = cuda_ms(lambda: calls.multi(X), 3)
        for name, src, q, ms, plain_ms, lib_ms, abs_err, err in (
            (single, src_single, 1, ms_single, plain_single_s * 1e3, lib_single, abs_single, err_single),
            (multi, src_multi, CHECK_Q, ms_multi, plain_s * 1e3, lib_multi, abs_multi, err_multi),
        ):
            rows[name] = {
                "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{SOURCES[family]}",
                "replaces": src, "launches": 0, "max_abs_err": abs_err, "max_entry_rel_err": err,
                "ms": ms, "plain_ms": plain_ms, **gram_bound(family, n, dx, m, q, rounds),
                "library_ms": lib_ms, "shape": {"n": n, "d": dx, "m": m, "q": q}, **gram_plan(family, n, dx, m),
            }
        emit({"phase": "kernels", "family": family, "n": n, "d": dx, "m": m, "q": CHECK_Q,
              "max_abs_err_multi": abs_multi, "max_abs_err_single": abs_single,
              "max_entry_rel_err_multi": err_multi, "max_entry_rel_err_single": err_single,
              "tol": GRAM_TOL, "multi_slices_bitwise_equal_single": bitwise,
              "rerun_bitwise": rerun, "ms_single": ms_single, "ms_multi": ms_multi,
              "plain_ms_single": plain_single_s * 1e3, "plain_ms_multi": plain_s * 1e3,
              "library_ms_single": lib_single, "library_ms_multi": lib_multi})
        check(err_multi <= GRAM_TOL, f"{multi} disagrees with its plain version")
        check(err_single <= GRAM_TOL, f"{single} disagrees with its plain version")
        check(bitwise, f"{multi} slices are not bitwise equal to single launches")
        check(rerun, f"{multi} is not bitwise equal run to run")


APPLY_ROUTES = {
    "gaussian": ("gaussian_sketch", "gaussian_sketch_multi", "src/repro/kernels/gaussian/kernel.py:29"),
    "rademacher": ("rademacher_sketch", "rademacher_sketch_multi", "src/repro/kernels/rademacher/kernel.py:16"),
    "sjlt": ("sjlt_apply", "sjlt_apply_multi", "src/repro/kernels/sjlt/kernel.py:25"),
}
FWHT_REPLACES = "src/repro/kernels/fwht/kernel.py:48"


class ApplyCalls:
    """A family's S·A wrappers and plain versions on the sketches of the worker
    keys ``keys``: ``single(w, X)``, ``multi(X)``, ``plain_single(w, X)``,
    ``plain_multi(X)``."""

    def __init__(self, family: str, keys, m: int):
        ops, ref = family_modules(family)
        single, multi, _ = APPLY_ROUTES[family]
        tail = (m, SJLT_S) if family == "sjlt" else (m,)
        self.single = lambda w, X: getattr(ops, single)(keys[w], X, *tail)
        self.multi = lambda X: getattr(ops, multi)(keys, X, *tail)
        self.plain_single = lambda w, X: ref.sketch(keys[w], X, *tail)
        self.plain_multi = lambda X: ref.sketch_multi(keys, X, *tail)


def sx_err(SX, want) -> float:
    """max over columns of max_i |ΔSX_ij| / rms_i(SX_ij) over a stack of sketches."""
    SX, want = SX.double().reshape(-1, *SX.shape[-2:]), want.double().reshape(-1, *want.shape[-2:])
    rms = want.pow(2).mean(dim=-2, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((SX - want).abs() / rms).max())


def apply_check(family: str, keys, Y, m: int, label: str) -> dict:
    """The single-key S·A entry of ``family`` on Y (the sketch of ``keys[0]``)
    against its plain version (per column ≤ SX_TOL) and a rerun (bitwise); its
    card, plain and library ms (means of 3 calls, or of 50 where a call is
    shorter than its host set-up, as at FIG4A) and its bound; for the SJLT also
    its device time under ``torch.profiler`` and the rest of the event time,
    the launch path. Emits one ``apply_kernels`` line."""
    import torch

    from repro_torch.kernels import common

    single = APPLY_ROUTES[family][0]
    calls = ApplyCalls(family, keys, m)
    ny, dx = Y.shape
    SX = calls.single(0, Y)
    rerun = torch.equal(calls.single(0, Y), SX)
    plain, plain_s = host_s(lambda: calls.plain_single(0, Y))
    err, abs_err = sx_err(SX, plain), float((SX - plain).abs().max())
    del SX, plain
    library = (sjlt_library if family == "sjlt" else dense_library)(Calls(family, keys, ny, m), Y, 1, gram=False)
    reps = 3 if ny * dx >= 10**6 else 50
    lib_ms, _ = cuda_ms(lambda: library(1), reps)
    del library
    torch.cuda.empty_cache()
    ms, _ = cuda_ms(lambda: calls.single(0, Y), reps)
    rounds = common.rng_rounds() if family == "gaussian" else common.DEFAULT_ROUNDS
    report = {"n": ny, "d": dx, "m": m, "ms": ms, "plain_ms": plain_s * 1e3, "library_ms": lib_ms,
              **apply_bound(family, ny, dx, m, 1, rounds), "max_abs_err": abs_err, "max_col_rel_err": err,
              "tol": SX_TOL, "rerun_bitwise": rerun, **apply_plan(family, ny, dx, m)}
    if family == "sjlt":  # the event time split into the card's own time and the launch path
        dev = device_ms(lambda: calls.single(0, Y), reps)
        report.update(device_ms=dev, launch_path_ms=ms - dev)
    emit({"phase": "apply_kernels", "name": single, "shape": label, **report})
    check(err <= SX_TOL, f"{single} on {(ny, dx)}, m = {m} disagrees with its plain version ({err})")
    check(rerun, f"{single} on {(ny, dx)}, m = {m} is not bitwise equal run to run")
    return report


def phase_apply_kernels(X, m: int, m_prime: int, rows: dict) -> None:
    """Each S·A kernel against its plain version: the single-key entry at q = 1 on
    the hybrid's m′ rows (its path) and on all n rows, the multi-key entry at
    q = 2 on all n rows (the two-pass path's shape), and the multi-key entry's
    slices across its first worker-chunk edge against single-key calls."""
    import torch

    from repro_torch.kernels import common, cuda
    from repro_torch.utils import prng

    n, dx = X.shape
    Xh = X[:m_prime].contiguous()
    keys = prng.worker_keys(prng.prng_key(SEED + 3), CHECK_Q)
    for family, (single, multi, src) in APPLY_ROUTES.items():
        calls = ApplyCalls(family, keys, m)
        rounds = common.rng_rounds() if family == "gaussian" else common.DEFAULT_ROUNDS
        make_library = sjlt_library if family == "sjlt" else dense_library
        report = {"phase": "apply_kernels", "family": family, "m": m, "d": dx, "tol": SX_TOL}
        for label, Y in (("hybrid", Xh), ("full", X)):
            report[label] = apply_check(family, keys, Y, m, label)
        h = report["hybrid"]
        rows[single] = {
            "name": single, "route": "cuda", "source": f"src/repro_torch/csrc/{APPLY_SOURCES[family]}",
            "replaces": src, "launches": 0, "max_abs_err": h["max_abs_err"],
            "max_col_rel_err": h["max_col_rel_err"], "ms": h["ms"], "plain_ms": h["plain_ms"],
            "bound_ms": h["bound_ms"], "bound_by": h["bound_by"], "ffma_bound_ms": h["ffma_bound_ms"],
            **{k: h[k] for k in ("smem_floor_ms", "device_ms", "launch_path_ms") if k in h},
            "library_ms": h["library_ms"], "shape": {"n": m_prime, "d": dx, "m": m, "q": 1},
            "full_n": report["full"], **apply_plan(family, m_prime, dx, m),
        }
        SXm = calls.multi(X)
        bitwise = all(torch.equal(SXm[w], calls.single(w, X)) for w in range(CHECK_Q))
        plain_m, plain_s = host_s(lambda: calls.plain_multi(X))
        err_m, abs_m = sx_err(SXm, plain_m), float((SXm - plain_m).abs().max())
        del plain_m
        library = make_library(Calls(family, keys, n, m), X, CHECK_Q, gram=False)
        lib_ms, _ = cuda_ms(lambda: library(CHECK_Q), 3)
        del library
        torch.cuda.empty_cache()
        ms_m, _ = cuda_ms(lambda: calls.multi(X), 3)
        bound = apply_bound(family, n, dx, m, CHECK_Q, rounds)
        b_ms = bound["bound_ms"]
        rows[multi] = {
            "name": multi, "route": "cuda", "source": f"src/repro_torch/csrc/{APPLY_SOURCES[family]}",
            "replaces": src, "launches": 0, "max_abs_err": abs_m, "max_col_rel_err": err_m,
            "ms": ms_m, "plain_ms": plain_s * 1e3, "bound_ms": b_ms, "bound_by": bound["bound_by"],
            "ffma_bound_ms": bound["ffma_bound_ms"], "library_ms": lib_ms,
            **({"smem_floor_ms": bound["smem_floor_ms"]} if "smem_floor_ms" in bound else {}),
            "shape": {"n": n, "d": dx, "m": m, "q": CHECK_Q}, **apply_plan(family, n, dx, m),
        }
        # The first worker-chunk edge of the multi-key entry at this shape.
        chunk = cuda.worker_chunk(n, m, dx, 1 << 20, family=family, s=SJLT_S, apply=True)
        edge_keys = prng.worker_keys(prng.prng_key(SEED + 5), chunk + 1)
        edge = ApplyCalls(family, edge_keys, m)
        SXe = edge.multi(X)
        edge_bitwise = {str(w): torch.equal(SXe[w], edge.single(w, X)) for w in (0, chunk - 1, chunk)}
        del SXe
        report.update(q=CHECK_Q, ms_multi=ms_m, plain_ms_multi=plain_s * 1e3, library_ms_multi=lib_ms,
                      bound_ms_multi=b_ms, max_col_rel_err_multi=err_m, max_abs_err_multi=abs_m,
                      multi_slices_bitwise_equal_single=bitwise, workers_per_call=chunk,
                      chunk_edge_slices_bitwise_equal_single=edge_bitwise)
        emit(report)
        check(err_m <= SX_TOL, f"{multi} disagrees with its plain version ({err_m})")
        check(bitwise, f"{multi} slices are not bitwise equal to single calls")
        check(all(edge_bitwise.values()), f"{multi} at q = {chunk + 1}: chunk-edge slices {edge_bitwise}")


def phase_fwht(X, m: int, m_prime: int, rows: dict) -> None:
    """The FWHT kernel (row 13b) and the fused SRHT forward (row 13a) against
    their plain versions, bitwise, on the rows the SRHT transforms: X zero-padded
    to the two-pass path's n_pad (2^19 at FIG3A), and X's first m′ rows
    zero-padded to the hybrid's (next_pow2(m′) = 2^15); the forward samples m rows."""
    import torch

    from repro_torch.core import operators, sketches as sk
    from repro_torch.utils import prng

    n, dx = X.shape
    for label, rows_in in (("shape", n), ("hybrid_shape", m_prime)):
        n_pad = sk.next_pow2(rows_in)
        x = torch.zeros((n_pad, dx), dtype=torch.float32, device=X.device)
        x[:rows_in] = X[:rows_in]
        r = fwht_check(x)
        del x
        kd, ids = operators.srht_params(prng.worker_key(prng.prng_key(SEED + 11), rows_in), m, n_pad)
        f = srht_forward_check(kd, ids, X[:rows_in], n_pad)
        for name, rep in (("fwht", r), ("srht_forward", f)):
            keys = ("ms", "plain_ms", "bound_ms", "composed_ms", "plan_floor_ms")
            shape = {"n_pad": n_pad, "d": dx, **{key: rep[key] for key in keys if key in rep}}
            if name not in rows:
                rows[name] = {
                    "name": name, "route": "cuda", "source": "src/repro_torch/csrc/fwht.cu",
                    "replaces": FWHT_REPLACES, "launches": 0, "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
                    "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                    "library_ms": None,
                }
            rows[name][label] = shape


def fwht_check(x) -> dict:
    """The FWHT kernel on x (2^p, k) against its plain version and a rerun, both
    bitwise; its card and plain ms and its bound. Emits one ``fwht`` line."""
    import torch

    from repro_torch.kernels import cuda
    from repro_torch.kernels.fwht import ops, ref

    n_pad, k = x.shape
    y = ops.fwht(x)
    plain, plain_s = host_s(lambda: ref.fwht(x))
    bitwise = torch.equal(y, plain)
    abs_err = float((y - plain).abs().max())
    del plain
    rerun = torch.equal(ops.fwht(x), y)
    ms, _ = cuda_ms(lambda: ops.fwht(x), 5)
    b_ms, b_by = fwht_bound_ms(n_pad, k)
    report = {"n_pad": n_pad, "k": k, "passes": list(cuda.plan_fwht(n_pad)), "ms": ms,
              "plain_ms": plain_s * 1e3, "bound_ms": b_ms, "bound_by": b_by, "bitwise_equal_plain": bitwise,
              "max_abs_err": abs_err, "rerun_bitwise": rerun}
    emit({"phase": "fwht", **report})
    check(bitwise, f"fwht on ({n_pad}, {k}) is not bitwise equal to its plain version")
    check(rerun, f"fwht on ({n_pad}, {k}) is not bitwise equal run to run")
    return report


def srht_forward_check(kd, ids, A, n_pad: int) -> dict:
    """The fused SRHT forward on A (n, k) for the diagonal key words kd and the
    (m,) sampled row ids against its plain version, a rerun and the composition
    it replaced on the card (torch D·A, zero rows, the full FWHT kernel, the
    gather), all bitwise; its card ms beside the composition's, the plain
    version's, its bound and its plan's bytes floor. Emits one
    ``srht_forward`` line."""
    import torch

    from repro_torch.kernels import common, cuda
    from repro_torch.kernels.fwht import ops, ref

    A = A.contiguous()
    n, k = A.shape
    m = ids.shape[0]
    kd0, kd1 = common.key_words(kd)

    def composed():
        DA = A * ref.diagonal(kd0, kd1, torch.arange(n, device=A.device))[:, None]
        if n_pad != n:
            DA = torch.cat([DA, DA.new_zeros((n_pad - n, k))])
        return ops.fwht(DA)[ids.to(A.device)] * common.inv_sqrt(m)

    fwd = lambda: ops.srht_forward(kd0, kd1, ids, A, n_pad)
    y = fwd()
    plain, plain_s = host_s(lambda: ref.srht_forward(kd0, kd1, ids, A, n_pad))
    bitwise = torch.equal(y, plain)
    abs_err = float((y - plain).abs().max())
    del plain
    rerun = torch.equal(fwd(), y)
    composed_bitwise = torch.equal(composed(), y)
    ms, _ = cuda_ms(fwd, 5)
    composed_ms, _ = cuda_ms(composed, 5)
    b_ms, b_by = srht_forward_bound_ms(n, k, m, n_pad)
    report = {"n": n, "k": k, "m": m, "n_pad": n_pad, "passes": list(cuda.plan_fwht(n_pad)), "ms": ms,
              "composed_ms": composed_ms, "plain_ms": plain_s * 1e3, "bound_ms": b_ms, "bound_by": b_by,
              "plan_floor_ms": srht_forward_floor_ms(n, k, m, n_pad), "bitwise_equal_plain": bitwise,
              "max_abs_err": abs_err, "rerun_bitwise": rerun, "composed_bitwise": composed_bitwise}
    emit({"phase": "srht_forward", **report})
    check(bitwise, f"srht_forward on ({n}, {k}) -> {m} rows is not bitwise equal to its plain version")
    check(rerun and composed_bitwise,
          f"srht_forward on ({n}, {k}): rerun {rerun}, composition {composed_bitwise} not bitwise equal")
    return report


def reset_counts() -> None:
    for family in FAMILY_ROUTES:
        family_modules(family)[0].LAUNCHES.clear()


def read_counts() -> dict:
    out = {}
    for family in FAMILY_ROUTES:
        out.update(family_modules(family)[0].LAUNCHES)
    return out


def check_counts(label: str, counts: dict, expect: dict) -> None:
    """Exactly the kernel calls of ``expect``, and no others."""
    for name, want in expect.items():
        check(counts.get(name, 0) == want, f"{label}: {name} launched {counts.get(name, 0)}×, want {want}")
    stray = {name: c for name, c in counts.items() if c and name not in expect}
    check(not stray, f"{label}: launched kernels it should not: {stray}")


@dataclass(frozen=True)
class Gate:
    """What a path's x̄ (d,) — or X̄ of ``shape`` for several targets — is held
    to: ``error(x̄)`` over ``pred``, the prediction of ``law`` for q averaged
    workers, within a band."""
    d: int
    q: int
    pred: float
    error: Callable
    law: str
    shape: tuple = ()


def theorem1(A64, b64, fstar, m: int, q: int) -> Gate:
    """Algorithm 1's gate: rel_err = f(x̄)/f* − 1 over Theorem 1."""
    from repro_torch.core import solve, theory

    d = A64.shape[1]
    return Gate(d, q, theory.gaussian_averaged_error(m, d, q),
                lambda x: float(solve.relative_error(A64, b64, x.double(), fstar)), "Theorem 1")


def lemma7(xstar, n: int, m: int, q: int) -> Gate:
    """The least-norm gate: ‖x̄ − x*‖²/‖x*‖² over Lemma 7 / q."""
    from repro_torch.core import theory

    def error(x):
        e = x.double() - xstar
        return float(e @ e / (xstar @ xstar))

    d = xstar.shape[0]
    return Gate(d, q, theory.gaussian_least_norm_error(m, n, d) / q, error, "Lemma 7/q")


def run_path(label: str, solve, expect: dict, gate: Gate, band=None, *, twice: bool = False,
             rows: dict | None = None, **fields):
    """Drive one path with the counts at 0; check that it made exactly the kernel
    calls of ``expect`` and no others, that x̄ is finite of shape (d,), and that its
    error over the gate's prediction lies within ``band`` (default
    [1/THEORY_FACTOR, THEORY_FACTOR]). With ``twice`` it runs again and must be
    bitwise equal. With ``rows``, each kernel it called records its calls there
    under ``label``. Returns (x̄, counts, seconds of the last run)."""
    import torch

    reset_counts()
    xbar, seconds = host_s(solve)
    counts = read_counts()
    rel = gate.error(xbar)
    lo, hi = band or (1 / THEORY_FACTOR, THEORY_FACTOR)
    report = {"phase": label, "q": gate.q, **fields, "seconds": seconds, "rel_err": rel, "theory": gate.pred,
              "ratio": rel / gate.pred, "ratio_band": [lo, hi], "launches": counts}
    if twice:
        x2, seconds = host_s(solve)
        report.update(seconds_rerun=seconds, rerun_bitwise=torch.equal(xbar, x2))
    emit(report)
    check(tuple(xbar.shape) == (gate.shape or (gate.d,)) and bool(torch.isfinite(xbar).all()), f"{label}: bad x̄")
    check_counts(label, counts, expect)
    check(not twice or report["rerun_bitwise"], f"{label}: x̄ is not bitwise equal run to run")
    check(lo * gate.pred <= rel <= hi * gate.pred,
          f"{label}: error {rel} outside [{lo}, {hi}]× {gate.law}'s {gate.pred}")
    for name, c in counts.items():
        if rows is not None and c:
            rows[name].setdefault("launches_by_path", {})[label] = c
    return xbar, counts, seconds


def check_main_path_slices(family: str, keys, X, m: int, G) -> None:
    """Slices of a main-path multi-key Gram at the edges of its worker chunks:
    bitwise equal to single-key calls, and the last held against the plain version."""
    import torch

    from repro_torch.kernels import cuda

    single, multi, *_ = FAMILY_ROUTES[family]
    n, dx = X.shape
    q = keys.shape[0]
    calls = Calls(family, keys, n, m)
    chunk = cuda.worker_chunk(n, m, dx, q, family=family, s=SJLT_S)
    ws = sorted({0, chunk - 1, chunk, q - 1} & set(range(q)))
    bitwise = {str(w): torch.equal(G[w], calls.single(w, X)) for w in ws}
    err = gram_err(G[q - 1], calls.plain_single(q - 1, X))
    emit({"phase": "main_path_slices", "name": multi, "q": q, "workers_per_call": chunk,
          "slices_bitwise_equal_single": bitwise, "last_slice_entry_rel_err": err,
          "tol": GRAM_TOL})
    check(all(bitwise.values()), f"{multi} at q = {q}: slices {bitwise} not all bitwise equal to {single}")
    check(err <= GRAM_TOL, f"{multi} at q = {q}: slice {q - 1} off its plain version by {err}")


def main_path_kernel(family: str, keys, X, m: int, rows: dict, **extra) -> None:
    """The main path's own multi-key kernel call, timed alone, then its slices checked."""
    from repro_torch.kernels import common

    multi = FAMILY_ROUTES[family][1]
    q = keys.shape[0]
    n, dx = X.shape
    calls = Calls(family, keys, n, m)
    ms, G = cuda_ms(lambda: calls.multi(X), 1, warmup=False)
    rounds = common.rng_rounds() if family == "gaussian" else common.DEFAULT_ROUNDS
    bound = gram_bound(family, n, dx, m, q, rounds)
    rows[multi].update(main_path_q=q, main_path_ms=ms, main_path_bound_ms=bound["bound_ms"],
                       main_path_ffma_bound_ms=bound["ffma_bound_ms"])
    if "smem_floor_ms" in bound:
        rows[multi]["main_path_smem_floor_ms"] = bound["smem_floor_ms"]
    emit({"phase": "main_path_kernel", "name": multi, "q": q, "ms": ms, **bound, **extra})
    check_main_path_slices(family, keys, X, m, G)


def phase_main_path(cfg, rows: dict):
    import torch

    from repro_torch.core import distributed, operators, sketches as sk, solve
    from repro_torch.data import regression
    from repro_torch.kernels import cuda
    from repro_torch.utils import prng

    A, b, _ = regression.gaussian_regression(SEED, cfg.n, cfg.d, device=DEVICE)
    A64, b64 = A.double(), b.double()
    (xstar, fstar), xs_s = host_s(lambda: _exact(solve, A64, b64))
    emit({"phase": "exact_solve", "seconds": xs_s, "fstar": float(fstar)})
    key = prng.prng_key(SEED)
    dx = cfg.d + 1
    X = torch.cat([A, b[:, None]], dim=1)

    def calls(family: str, q: int) -> int:
        return -(-q // cuda.worker_chunk(cfg.n, cfg.m, dx, q, family=family, s=SJLT_S))

    def gate(q):
        return theorem1(A64, b64, fstar, cfg.m, q)

    def master(spec, q):
        return lambda: distributed.distributed_sketch_solve_master(spec, key, A, b, q=q, device=DEVICE)

    def worker(spec, q):
        return lambda: distributed.distributed_sketch_solve(spec, key, A, b, q=q, device=DEVICE)

    def master_twice(label, family, spec, band=None):
        multi = FAMILY_ROUTES[family][1]
        xbar, counts, seconds2 = run_path(label, master(spec, cfg.q), {multi: calls(family, cfg.q)}, gate(cfg.q),
                                          band, twice=True)
        rows[multi]["launches"] = counts.get(multi, 0)
        master_rel[label] = gate(cfg.q).error(xbar)
        return seconds2

    def worker_side(label, family, spec, band=None):
        single = FAMILY_ROUTES[family][0]
        _, counts, _ = run_path(label, worker(spec, SIDE_Q), {single: SIDE_Q}, gate(SIDE_Q), band)
        rows[single]["launches"] = counts.get(single, 0)

    master_rel: dict = {}
    gauss = sk.SketchSpec("gaussian", cfg.m, use_kernel=True)
    seconds2 = master_twice("master_gaussian", "gaussian", gauss)
    phase_trace("master_gaussian_traced", master(gauss, cfg.q))
    keys = prng.worker_keys(key, cfg.q)
    main_path_kernel("gaussian", keys, X, cfg.m, rows, solve_seconds=seconds2)

    rad = sk.SketchSpec("rademacher", cfg.m, use_kernel=True)
    worker_side("worker_gaussian", "gaussian", gauss)
    _, counts, _ = run_path("master_rademacher", master(rad, SIDE_Q),
                            {"rademacher_gram_multi": calls("rademacher", SIDE_Q)}, gate(SIDE_Q))
    rows["rademacher_gram_multi"]["launches"] = counts.get("rademacher_gram_multi", 0)
    worker_side("worker_rademacher", "rademacher", rad)
    main_path_kernel("rademacher", prng.worker_keys(key, SIDE_Q), X, cfg.m, rows)

    # The SRHT's row ids for q workers are drawn on the host inside the solve (timed
    # twice: the first call also pays the CPU kernels' first use).
    draw = lambda: operators.srht_params(keys, cfg.m, sk.next_pow2(cfg.n))
    (_, first_s), (_, draw_s) = host_s(draw), host_s(draw)
    emit({"phase": "srht_row_draw", "q": cfg.q, "m": cfg.m, "seconds_first": first_s,
          "seconds": draw_s})
    srht = sk.SketchSpec("srht", cfg.m, use_kernel=True)
    seconds2 = master_twice("master_srht", "srht", srht, THEORY_BAND["srht"])
    main_path_kernel("srht", keys, X, cfg.m, rows, solve_seconds=seconds2, row_draw_seconds=draw_s)
    worker_side("worker_srht", "srht", srht, THEORY_BAND["srht"])

    sjlt = sk.SketchSpec("sjlt", cfg.m, s=SJLT_S, use_kernel=True)
    seconds2 = master_twice("master_sjlt", "sjlt", sjlt, THEORY_BAND["sjlt"])
    phase_trace("master_sjlt_traced", master(sjlt, cfg.q))
    main_path_kernel("sjlt", keys, X, cfg.m, rows, solve_seconds=seconds2)
    worker_side("worker_sjlt", "sjlt", sjlt, THEORY_BAND["sjlt"])
    del X
    torch.cuda.empty_cache()
    phase_new_paths(cfg, rows, key, A, b, gate)
    phase_remaining_paths(cfg, rows, key, A, b, A64, b64, fstar, gate, master_rel["master_gaussian"])


def phase_new_paths(cfg, rows: dict, key, A, b, gate) -> None:
    """The hybrid, uniform sampling, the two-pass reference and leverage sampling,
    each run twice (bitwise equal), with the S·A and SRHT forward kernel calls each makes."""
    from repro_torch.core import distributed, operators, sketches as sk
    from repro_torch.kernels import cuda
    from repro_torch.utils import prng

    dx = cfg.d + 1
    master, worker = distributed.distributed_sketch_solve_master, distributed.distributed_sketch_solve

    def path(entry, spec, q, method="fused"):
        return lambda: entry(spec, key, A, b, q=q, method=method, device=DEVICE)

    def twice(label, solve, expect, q, band):
        x, counts, _ = run_path(label, solve, expect, gate(q), band, twice=True)
        return x, counts

    def hybrid(inner):
        return sk.SketchSpec("hybrid", cfg.m, m_prime=cfg.m_prime, inner=inner, s=SJLT_S, use_kernel=True)

    # The hybrid's row draw on the card for one worker: gumbel top-m′ of n (timed
    # twice: the first call also pays first use).
    k1 = prng.split(prng.worker_key(key, 0))[0]
    draw = lambda: prng.gumbel_top_k(k1, cfg.n, cfg.m_prime, device=A.device)
    (_, first_s), (_, draw_s) = host_s(draw), host_s(draw)
    emit({"phase": "hybrid_row_draw", "n": cfg.n, "m_prime": cfg.m_prime, "seconds_first": first_s,
          "seconds": draw_s})

    _, counts = twice("master_hybrid_sjlt", path(master, hybrid("sjlt"), cfg.q), {"sjlt_apply": cfg.q},
                      cfg.q, THEORY_BAND["hybrid_sjlt"])
    rows["sjlt_apply"]["launches"] = counts.get("sjlt_apply", 0)
    phase_trace("master_hybrid_sjlt_traced", path(master, hybrid("sjlt"), cfg.q))
    twice("master_uniform", path(master, sk.SketchSpec("uniform", cfg.m, replacement=False), cfg.q), {},
          cfg.q, THEORY_BAND["uniform"])
    for inner, name in (("gaussian", "gaussian_sketch"), ("rademacher", "rademacher_sketch"),
                        ("srht", "srht_forward")):
        _, counts = twice(f"worker_hybrid_{inner}", path(worker, hybrid(inner), SIDE_Q), {name: SIDE_Q},
                          SIDE_Q, THEORY_BAND[f"hybrid_{inner}"])
        rows[name].setdefault("launches_by_path", {})[f"worker_hybrid_{inner}"] = counts.get(name, 0)
        rows[name]["launches"] = counts.get(name, 0)

    for family in ("gaussian", "rademacher", "srht", "sjlt"):
        spec = sk.SketchSpec(family, cfg.m, s=SJLT_S, use_kernel=True)
        if family == "srht":
            name, want = "srht_forward", SIDE_Q
        else:
            name = APPLY_ROUTES[family][1]
            want = -(-SIDE_Q // cuda.worker_chunk(cfg.n, cfg.m, dx, SIDE_Q, family=family, s=SJLT_S,
                                                  apply=True))
        x_qr, counts = twice(f"master_qr_{family}", path(master, spec, SIDE_Q, "qr"), {name: want},
                             SIDE_Q, THEORY_BAND.get(family))
        rows[name].setdefault("launches_by_path", {})[f"master_qr_{family}"] = counts.get(name, 0)
        rows[name]["launches"] = counts.get(name, 0)
        x_fused, fused_s = host_s(path(master, spec, SIDE_Q))
        rel = float((x_qr - x_fused).abs().max() / x_fused.abs().max())
        emit({"phase": f"master_qr_{family}_vs_fused", "q": SIDE_Q, "fused_seconds": fused_s,
              "max_rel_diff": rel, "tol": QR_FUSED_TOL})
        check(rel <= QR_FUSED_TOL, f"master_qr_{family}: x̄ {rel} off the fused x̄ (same S)")

    # Leverage sampling: the scores (a float32 QR of A) and one worker's row draw,
    # timed apart, then the path (each worker computes the scores again).
    lev = sk.SketchSpec("leverage", cfg.m)
    scores, scores_s = host_s(lambda: sk.leverage_scores(A))
    _, draw_s = host_s(lambda: operators.make_operator(lev, prng.worker_key(key, 0), cfg.n, scores=scores))
    emit({"phase": "leverage_row_draw", "n": cfg.n, "m": cfg.m, "gumbels": cfg.m * cfg.n,
          "scores_seconds": scores_s, "draw_seconds": draw_s})
    del scores
    twice("worker_leverage", path(worker, lev, LEVERAGE_Q), {}, LEVERAGE_Q, THEORY_BAND["leverage"])

# Paths of the paper's other solvers and data (IHS, multi-round waves, straggler
# masks, CG, the host-streamed Gram; Fig. 3a's student-t data and Fig. 2's
# EMNIST-like least squares).
IHS_ITERS = 10
IHS_MIN_CUT = 2.0  # each of IHS's first three steps cuts rel_err at least this much
MULTIROUND_Q, MULTIROUND_R = 50, 4  # waves of workers: an effective q of 200
STRAGGLER_DROP, STRAGGLER_QUANTILE = 0.1, 0.8
CG_Q = 8
HOST_BLOCK_ROWS = (4096, 65_536)
# Fig. 3a's data: student-t(1.5) entries, noise 0.1 (FIG3A.heavy_tail_df). rel_err /
# Theorem 1 of the JAX reference on the CPU (tests/theory_ratio.py --student-t 1.5,
# PERF.md §6), master mode, per kind: (least, most) over seeds 1-4 at FIG3A's shape
# (n = 500,000, d = 250, m = 2,500, m′ = 25,000, q = 200). The uniform ratio falls
# with d (4.9-9.3 at d = 25, 3.1-4.7 at d = 100); the hybrid's too (1.8-5.2, 1.5-2.6).
# The gate is [least/2, 2·most]. Theorem 1 is exact for the Gaussian on any full-rank
# A: its band is THEORY_FACTOR's.
STUDENT_T_RATIO = {"uniform": (2.766, 3.336), "hybrid_sjlt": (1.226, 1.434)}
STUDENT_T_NOISE = 0.1
# Fig. 2's EMNIST-like least squares (benchmarks/fig2_emnist.py, full size): 200,000
# training and 30,000 test rows from one draw (the same class templates), d = 784,
# 47 one-hot targets, m = 2,000, SJLT s = 20, q = 100. The gate: (f(X̄) − f*)/f* over
# Theorem 1 within [least/2, 2·most] of the reference's ratio on the CPU
# (tests/theory_ratio.py --emnist, PERF.md §6).
EMNIST = {"n": 200_000, "n_test": 30_000, "m": 2000, "q": 100}
# At this full size, seeds 1-4: SJLT 0.9947-1.0010, uniform 0.9794-1.0148.
EMNIST_RATIO = {"sjlt": (0.994, 1.001), "uniform": (0.979, 1.015)}


def phase_remaining_paths(cfg, rows: dict, key, A, b, A64, b64, fstar, gate, master_gaussian_rel: float) -> None:
    """On FIG3A's Gaussian data: IHS (one Gram kernel call for its 10 keys), the
    multi-round waves, a straggler mask drawn on the card, the master CG, and
    the host-streamed Gram."""
    import torch

    from repro_torch.core import averaging, distributed, ihs, sketches as sk
    from repro_torch.kernels import cuda
    from repro_torch.utils import prng

    gauss = sk.SketchSpec("gaussian", cfg.m, use_kernel=True)
    sjlt = sk.SketchSpec("sjlt", cfg.m, s=SJLT_S, use_kernel=True)

    # IHS: all 10 Hessians from one multi-key Gram of A (no b column), then 10 solves.
    chunk = cuda.worker_chunk(cfg.n, cfg.m, cfg.d, IHS_ITERS, family="gaussian")
    want = {"gaussian_gram_multi": -(-IHS_ITERS // chunk)}
    run = lambda: ihs.ihs_trace(gauss, key, A, b, iters=IHS_ITERS, device=DEVICE)
    reset_counts()
    trace, seconds = host_s(run)
    counts = read_counts()
    trace2, seconds2 = host_s(run)
    rel = [gate(1).error(torch.zeros_like(trace[0]))] + [gate(1).error(x) for x in trace]
    cuts = [rel[t] / rel[t + 1] for t in range(len(rel) - 1)]
    emit({"phase": "ihs_fig3a_gaussian", "iters": IHS_ITERS, "m": cfg.m, "seconds": seconds,
          "seconds_rerun": seconds2, "rel_err": rel, "step_cuts": cuts, "master_gaussian_rel_err": master_gaussian_rel,
          "theory_q200": gate(cfg.q).pred, "launches": counts, "rerun_bitwise": torch.equal(trace, trace2)})
    check_counts("ihs_fig3a_gaussian", counts, want)
    check(torch.equal(trace, trace2), "ihs_fig3a_gaussian: the trace is not bitwise equal run to run")
    check(bool(torch.isfinite(trace).all()), "ihs_fig3a_gaussian: non-finite iterates")
    check(all(c >= IHS_MIN_CUT for c in cuts[:3]), f"ihs_fig3a_gaussian: first steps cut rel_err by {cuts[:3]}")
    check(rel[-1] < master_gaussian_rel,
          f"ihs_fig3a_gaussian: rel_err {rel[-1]} after {IHS_ITERS} steps not below the q = 200 x̄'s {master_gaussian_rel}")
    rows["gaussian_gram_multi"].setdefault("launches_by_path", {})["ihs_fig3a_gaussian"] = counts.get(
        "gaussian_gram_multi", 0)

    # Multi-round waves: R waves of q workers, worker-side SJLT, gated at q = R·q.
    waves = lambda r: lambda: distributed.distributed_sketch_solve_multiround(
        sjlt, key, A, b, q=MULTIROUND_Q, rounds=r, device=DEVICE)
    run_path("multiround_sjlt", waves(MULTIROUND_R), {"sjlt_gram": MULTIROUND_Q * MULTIROUND_R},
             gate(MULTIROUND_Q * MULTIROUND_R), THEORY_BAND["sjlt"], twice=True, rows=rows,
             rounds=MULTIROUND_R, workers_a_round=MULTIROUND_Q)
    one = waves(1)()
    single = distributed.distributed_sketch_solve(sjlt, key, A, b, q=MULTIROUND_Q, device=DEVICE)
    emit({"phase": "multiround_one_round", "q": MULTIROUND_Q, "bitwise_equal_distributed_sketch_solve":
          torch.equal(one, single)})
    check(torch.equal(one, single), "multiround_sjlt: rounds=1 is not bitwise distributed_sketch_solve")

    # A straggler mask drawn on the card feeds the master: Theorem 1 at the realized q'.
    mkey = prng.prng_key(SEED + 7)
    mask, mask_s = host_s(lambda: averaging.simulate_straggler_mask(
        mkey, cfg.q, drop_prob=STRAGGLER_DROP, deadline_quantile=STRAGGLER_QUANTILE, device=DEVICE))
    on_cpu = averaging.simulate_straggler_mask(mkey, cfg.q, drop_prob=STRAGGLER_DROP,
                                               deadline_quantile=STRAGGLER_QUANTILE, device="cpu")
    arrived = int(mask.sum())
    emit({"phase": "straggler_mask", "q": cfg.q, "drop_prob": STRAGGLER_DROP, "deadline_quantile": STRAGGLER_QUANTILE,
          "arrived": arrived, "seconds": mask_s, "bitwise_equal_cpu_draw": torch.equal(mask.cpu(), on_cpu)})
    check(torch.equal(mask.cpu(), on_cpu), "straggler_mask: the card's mask is not the CPU's")
    calls_g = -(-cfg.q // cuda.worker_chunk(cfg.n, cfg.m, cfg.d + 1, cfg.q, family="gaussian"))
    run_path("master_gaussian_stragglers", lambda: distributed.distributed_sketch_solve_master(
        gauss, key, A, b, q=cfg.q, straggler_mask=mask, device=DEVICE), {"gaussian_gram_multi": calls_g},
        gate(arrived), twice=True, rows=rows, arrived=arrived)

    # CG on each worker's sketched problem (the two-pass master), against the fused x̄.
    chunk_a = cuda.worker_chunk(cfg.n, cfg.m, cfg.d + 1, CG_Q, family="gaussian", apply=True)
    x_cg, _, _ = run_path("master_cg_gaussian", lambda: distributed.distributed_sketch_solve_master(
        gauss, key, A, b, q=CG_Q, method="cg", device=DEVICE), {"gaussian_sketch_multi": -(-CG_Q // chunk_a)},
        gate(CG_Q), twice=True, rows=rows)
    x_fused = distributed.distributed_sketch_solve_master(gauss, key, A, b, q=CG_Q, device=DEVICE)
    diff = float((x_cg - x_fused).abs().max() / x_fused.abs().max())
    emit({"phase": "master_cg_gaussian_vs_fused", "q": CG_Q, "max_rel_diff": diff, "tol": QR_FUSED_TOL})
    check(diff <= QR_FUSED_TOL, f"master_cg_gaussian: x̄ {diff} off the fused x̄ (same S)")

    phase_host_stream(cfg, rows, key, A, b)


def phase_host_stream(cfg, rows: dict, key, A, b) -> None:
    """``gram_blocked_host`` over FIG3A's [A | b] in pinned host memory, in tiles
    of HOST_BLOCK_ROWS rows, for the Gaussian and SJLT S·A kernels at their row
    offsets, against ``gram_blocked`` on the card (the Gram rows' measure):
    exact kernel calls, a bitwise rerun, ms, the stream's GB/s (the bytes over
    the whole call: staging, copies, kernels, sums), one plain ``copy_`` of the
    same bytes, and the host's staging of every tile into a pinned buffer alone."""
    import torch

    from repro_torch.core import operators, sketches as sk

    X = torch.cat([A, b[:, None]], dim=1)
    host = torch.empty(X.shape, dtype=torch.float32, pin_memory=DEVICE != "cpu")
    host.copy_(X)
    Xh = host.numpy()
    nbytes = host.numel() * 4
    dev_copy = torch.empty_like(X)
    plain_s = min(host_s(lambda: dev_copy.copy_(host, non_blocking=True))[1] for _ in range(3))
    del dev_copy
    staging = torch.empty((max(HOST_BLOCK_ROWS), Xh.shape[1]), dtype=torch.float32, pin_memory=DEVICE != "cpu")

    def stage_all(bs: int) -> None:  # what gram_blocked_host's host side does to each tile, alone
        view = staging.numpy()
        for j0 in range(0, cfg.n, bs):
            rows = min(bs, cfg.n - j0)
            view[:rows] = Xh[j0 : j0 + rows]

    for family, name in (("gaussian", "gaussian_sketch"), ("sjlt", "sjlt_apply")):
        spec = sk.SketchSpec(family, cfg.m, s=SJLT_S, use_kernel=True)
        want = operators.gram_blocked(spec, key, X)[0]
        for bs in HOST_BLOCK_ROWS:
            label = f"host_stream_{family}_{bs}"
            run = lambda: operators.gram_blocked_host(spec, key, Xh, None, block_rows=bs, device=DEVICE)[0]
            reset_counts()
            G, seconds = host_s(run)
            counts = read_counts()
            G2, seconds2 = host_s(run)
            err = gram_err(G, want)
            tiles = -(-cfg.n // bs)
            stage_s = min(host_s(lambda: stage_all(bs))[1] for _ in range(2))
            emit({"phase": label, "block_rows": bs, "tiles": tiles, "bytes": nbytes, "seconds": seconds,
                  "seconds_rerun": seconds2, "stream_gb_s": nbytes / min(seconds, seconds2) / 1e9,
                  "plain_copy_seconds": plain_s, "plain_copy_gb_s": nbytes / plain_s / 1e9,
                  "host_staging_seconds": stage_s, "host_staging_gb_s": nbytes / stage_s / 1e9,
                  "entry_rel_err_vs_gram_blocked": err, "tol": GRAM_TOL, "launches": counts,
                  "rerun_bitwise": torch.equal(G, G2)})
            check_counts(label, counts, {name: tiles})
            check(torch.equal(G, G2), f"{label}: G is not bitwise equal run to run")
            check(err <= GRAM_TOL, f"{label}: G off gram_blocked's by {err}")
            rows[name].setdefault("launches_by_path", {})[label] = counts.get(name, 0)
        del want
    del X, host, staging
    torch.cuda.empty_cache()


def offset_library(family: str, key, Y, m: int, row0: int):
    """The yardstick at a row offset: the dense S tile ``S[:, row0 : row0 + n]``
    drawn once with the plain tiles, then one ``torch.matmul`` for S·Y; for the
    SJLT the signed rows of Y (their (row, t) draws at the global rows) made once,
    then one ``index_add_`` into (m, d). Returns ``run()``; the port never calls it."""
    import torch

    from repro_torch.kernels import common

    n, dx = Y.shape
    k0, k1 = common.key_words(key)
    if family == "sjlt":
        rows = torch.arange(row0, row0 + n, dtype=torch.int64, device=Y.device)
        buckets, signs = common.sjlt_counter_params(k0, k1, rows, SJLT_S, m)
        idx, src = buckets.reshape(-1), (signs[..., None] * Y[:, None, :]).reshape(n * SJLT_S, dx)
        return lambda: torch.zeros((m, dx), dtype=torch.float32, device=Y.device).index_add_(0, idx, src)
    S = family_modules(family)[1].columns(k0, k1, m, row0, n, Y.device)

    def run():
        with common.full_fp32_matmul():
            return S @ Y

    return run


def phase_row_offsets(X, m: int, rows: dict) -> None:
    """Rows 6, 7 and 12 at a row offset: the single-key S·A of a tile of
    HOST_BLOCK_ROWS[0] rows of FIG3A's X whose first row is data row row0 (the
    host stream's tile shape), against its plain version at the same offset
    (SX_TOL), a rerun (bitwise), ms, bound and the library's ms on the same tile."""
    import torch

    from repro_torch.kernels import common
    from repro_torch.utils import prng

    bs = HOST_BLOCK_ROWS[0]
    row0 = (X.shape[0] // 2) // bs * bs
    Y = X[row0 : row0 + bs].contiguous()
    key = prng.prng_key(SEED + 11)
    for family, (single, _, _) in APPLY_ROUTES.items():
        ops, ref = family_modules(family)
        tail = (m, SJLT_S) if family == "sjlt" else (m,)
        kernel = lambda: getattr(ops, single)(key, Y, *tail, row0=row0)
        SX = kernel()
        rerun = torch.equal(kernel(), SX)
        plain, plain_s = host_s(lambda: ref.sketch(key, Y, *tail, row0=row0))
        err, abs_err = sx_err(SX, plain), float((SX - plain).abs().max())
        library = offset_library(family, key, Y, m, row0)
        lib_ms, lib_SX = cuda_ms(library, 20)
        lib_err = sx_err(lib_SX, plain)
        del library, lib_SX
        ms, _ = cuda_ms(kernel, 20)
        rounds = common.rng_rounds() if family == "gaussian" else common.DEFAULT_ROUNDS
        report = {"n": bs, "d": Y.shape[1], "m": m, "row0": row0, "ms": ms, "plain_ms": plain_s * 1e3,
                  "library_ms": lib_ms, "library_max_col_rel_err": lib_err,
                  **apply_bound(family, bs, Y.shape[1], m, 1, rounds), "max_abs_err": abs_err,
                  "max_col_rel_err": err, "tol": SX_TOL, "rerun_bitwise": rerun}
        emit({"phase": "row_offset", "name": single, **report})
        rows[single]["offset_shape"] = report
        check(err <= SX_TOL, f"{single} at row0 = {row0} disagrees with its plain version ({err})")
        check(rerun, f"{single} at row0 = {row0} is not bitwise equal run to run")


def ratio_band(ratio) -> tuple:
    least, most = ratio
    return (least / 2, 2 * most)


def phase_fig3a_student_t(cfg, rows: dict) -> None:
    """Fig. 3a's own data (student-t(1.5) entries, FIG3A.heavy_tail_df) in master
    mode at q = 200: the Gaussian (Theorem 1, exact for any full-rank A), uniform
    sampling without replacement and the hybrid with the SJLT inside (bands
    around the reference's ratios on the same kind of data); and the float32
    floor: worker 0's fp32 x̂ against a float64 solve of its own (G, c)."""
    import torch

    from repro_torch.core import distributed, operators, sketches as sk, solve
    from repro_torch.data import regression
    from repro_torch.kernels import cuda
    from repro_torch.utils import prng

    A, b, _ = regression.student_t_regression(SEED + 13, cfg.n, cfg.d, df=cfg.heavy_tail_df,
                                              noise=STUDENT_T_NOISE, device=DEVICE)
    A64, b64 = A.double(), b.double()
    (xstar, fstar), xs_s = host_s(lambda: _exact(solve, A64, b64))
    key = prng.prng_key(SEED + 14)
    gate = lambda q: theorem1(A64, b64, fstar, cfg.m, q)
    emit({"phase": "fig3a_student_t_data", "df": cfg.heavy_tail_df, "noise": STUDENT_T_NOISE, "exact_seconds": xs_s,
          "fstar": float(fstar), "fstar_over_b2": float(fstar / (b64 @ b64)), "max_abs_a": float(A.abs().max())})
    gauss = sk.SketchSpec("gaussian", cfg.m, use_kernel=True)
    # The float32 floor at this data: one worker's fp32 solve against float64 on the same (G, c).
    G, c = operators.gram_batched(gauss, prng.worker_keys(key, 1), A, b)
    x32 = solve.lstsq_gram(G, c)[0]
    x64 = torch.linalg.solve(G[0].double(), c[0].double())
    err = gate(1).error
    floor = abs(err(x32) - err(x64))
    emit({"phase": "fig3a_student_t_fp32_floor", "worker_rel_err_fp32": err(x32), "worker_rel_err_fp64": err(x64),
          "floor": floor, "theorem1_q200": gate(cfg.q).pred, "lemma1": gate(1).pred})
    del G, c
    master = lambda spec: lambda: distributed.distributed_sketch_solve_master(spec, key, A, b, q=cfg.q, device=DEVICE)
    calls_g = -(-cfg.q // cuda.worker_chunk(cfg.n, cfg.m, cfg.d + 1, cfg.q, family="gaussian"))
    run_path("fig3a_student_t_gaussian", master(gauss), {"gaussian_gram_multi": calls_g}, gate(cfg.q), twice=True,
             rows=rows, fp32_floor=floor)
    run_path("fig3a_student_t_uniform_norep", master(sk.SketchSpec("uniform", cfg.m, replacement=False)), {},
             gate(cfg.q), ratio_band(STUDENT_T_RATIO["uniform"]), twice=True, rows=rows)
    hybrid = sk.SketchSpec("hybrid", cfg.m, m_prime=cfg.m_prime, inner="sjlt", s=SJLT_S, use_kernel=True)
    run_path("fig3a_student_t_hybrid_sjlt", master(hybrid), {"sjlt_apply": cfg.q}, gate(cfg.q),
             ratio_band(STUDENT_T_RATIO["hybrid_sjlt"]), twice=True, rows=rows)
    del A, b, A64, b64
    torch.cuda.empty_cache()


def phase_fig2_emnist(rows: dict) -> None:
    """Fig. 2's EMNIST-like multiclass least squares at its full size, master
    mode: the SJLT (the first kernel path with X 831 columns wide and 47
    targets) and uniform sampling without replacement, each gated on its cost
    ratio over Theorem 1 against the reference's, with the test accuracy of X̄
    and of the float64 X*."""
    import dataclasses

    import torch

    from repro_torch.core import distributed, sketches as sk, solve
    from repro_torch.data import regression
    from repro_torch.kernels import cuda
    from repro_torch.utils import prng

    n, n_test, m, q = EMNIST["n"], EMNIST["n_test"], EMNIST["m"], EMNIST["q"]
    A_all, B_all, meta = regression.emnist_like(SEED + 17, n + n_test, device=DEVICE)
    A, B = A_all[:n], B_all[:n]
    At, labels_t = A_all[n:], meta["labels"][n:]
    d, k = A.shape[1], B.shape[1]
    A64, B64 = A.double(), B.double()
    (Xstar, fstar), xs_s = host_s(lambda: _exact(solve, A64, B64))
    acc_star = float(regression.accuracy(At.double(), None, Xstar, labels_t))
    key = prng.prng_key(SEED + 18)
    gate = dataclasses.replace(theorem1(A64, B64, fstar, m, q), shape=(d, k))
    emit({"phase": "fig2_emnist_data", "n": n, "n_test": n_test, "d": d, "targets": k, "m": m, "q": q,
          "exact_seconds": xs_s, "fstar": float(fstar), "test_accuracy_xstar": acc_star})
    master = lambda spec: lambda: distributed.distributed_sketch_solve_master(spec, key, A, B, q=q, device=DEVICE)
    chunk = cuda.worker_chunk(n, m, d + k, q, family="sjlt", s=SJLT_S)
    for label, spec, want, ratio in (
            ("fig2_emnist_sjlt", sk.SketchSpec("sjlt", m, s=SJLT_S, use_kernel=True),
             {"sjlt_gram_multi": -(-q // chunk)}, EMNIST_RATIO["sjlt"]),
            ("fig2_emnist_uniform_norep", sk.SketchSpec("uniform", m, replacement=False), {}, EMNIST_RATIO["uniform"])):
        Xbar, _, _ = run_path(label, master(spec), want, gate, ratio_band(ratio), twice=True, rows=rows,
                              targets=k, workers_per_call=chunk if want else None)
        acc = float(regression.accuracy(At, None, Xbar, labels_t))
        emit({"phase": f"{label}_accuracy", "test_accuracy_xbar": acc, "test_accuracy_xstar": acc_star})
    del A_all, B_all, A64, B64
    torch.cuda.empty_cache()


ADJOINT_REPLACES = "src/repro/kernels/gaussian/gram.py:152"
# (m, n, k) of the Gaussian adjoint on the least-norm paths: the Fig. 4(b) Gaussian
# and hybrid-inner sketches, FIG4A's two, and one ragged k > 1 shape.
ADJOINT_SHAPES = ((4000, 11_556, 1), (4000, 8000, 1), (200, 1000, 1), (200, 500, 1), (129, 1001, 3))


def kept_bound_ms(m: int, n: int, k: int) -> tuple[float, str]:
    """Least time for Sᵀ·Y over a kept S (m, n) float32: S and Y read once and the
    (n, k) output written once, or 2·m·n·k FFMA flops at the fp32 rate."""
    bytes_ms = 4 * (m * n + m * k + n * k) / PEAK_BYTES * 1e3
    ops_ms = 2 * m * n * k / PEAK_FP32_FLOPS * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def wrapper_host_us(fn, calls: int = 300) -> float:
    """Host microseconds a call of ``fn`` over ``calls`` calls in a row (after 20)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def phase_adjoint_kernel(rows: dict) -> None:
    """Both Gaussian adjoint kernels at each of ADJOINT_SHAPES, on the S a forward
    S·A kept (``gaussian_sketch_keep`` on a vector x) and Y: the kept-S kernel and
    the redraw kernel each against the plain version (float64 product of the same
    float32 S: per column max_i |Δ|/rms_i ≤ SX_TOL), ⟨S·x, y⟩ = ⟨x, Sᵀ·y⟩ with S·x
    from that forward, a bitwise rerun, one launch a call; the two bitwise equal
    (the same splits, chains and order); card ms of both, plain ms, the
    library's ``torch.matmul(S.T, Y)`` on the same S (the means of four runs
    each, interleaved: kept, library, redraw, redraw, library, kept, twice), their bounds (bytes for the kept one, the draw for
    the redraw one) and the host µs a call of the kept wrapper and the library."""
    import torch

    from repro_torch.kernels.gaussian import ops, ref
    from repro_torch.utils import prng

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    for m, n, k in ADJOINT_SHAPES:
        key = prng.worker_key(prng.prng_key(SEED + 6), m + n + k)
        Y = torch.randn((m, k), generator=g, device=DEVICE)
        x = torch.randn((n, 1), generator=g, device=DEVICE)
        Sx, S = ops.gaussian_sketch_keep(key, x, m)
        launches = {}
        outs = {}
        for name, call in (("gaussian_adjoint_kept", lambda: ops.gaussian_adjoint_kept(S, Y, n)),
                           ("gaussian_adjoint", lambda: ops.gaussian_adjoint(key, Y, n))):
            before = ops.LAUNCHES[name]
            outs[name] = call()
            launches[name] = ops.LAUNCHES[name] - before
        kept, redraw = outs["gaussian_adjoint_kept"], outs["gaussian_adjoint"]
        reruns = {"gaussian_adjoint_kept": torch.equal(ops.gaussian_adjoint_kept(S, Y, n), kept),
                  "gaussian_adjoint": torch.equal(ops.gaussian_adjoint(key, Y, n), redraw)}
        plain, plain_s = host_s(lambda: ref.adjoint(key, Y, n))
        errs = {name: (sx_err(out, plain), float((out - plain).abs().max())) for name, out in outs.items()}
        del plain
        Sty = ops.gaussian_adjoint_kept(S, Y[:, :1].contiguous(), n)
        lhs, rhs = float(Sx.double().T @ Y[:, :1].double()), float(x.double().T @ Sty.double())
        ident = abs(lhs - rhs) / float(Sx.norm() * Y[:, 0].norm() + x.norm() * Sty.norm())
        bitwise = torch.equal(kept, redraw)
        kept_vs_redraw = sx_err(kept, redraw)
        Sv = S[:, :n]
        reps = 10 if m * n >= 10**6 else 50
        calls = {"kept": lambda: ops.gaussian_adjoint_kept(S, Y, n), "library": lambda: torch.matmul(Sv.T, Y),
                 "redraw": lambda: ops.gaussian_adjoint(key, Y, n)}  # TF32 is off (main)
        runs = {name: [] for name in calls}
        for name in ("kept", "library", "redraw", "redraw", "library", "kept") * 2:
            runs[name].append(cuda_ms(calls[name], reps)[0])
        kept_ms, lib_ms, redraw_ms = (sum(runs[name]) / len(runs[name]) for name in ("kept", "library", "redraw"))
        host_us = wrapper_host_us(calls["kept"])
        lib_host_us = wrapper_host_us(calls["library"])
        kb_ms, kb_by = kept_bound_ms(m, n, k)
        rb_ms, rb_by = adjoint_bound_ms(m, n, k)
        shape = {"m": m, "n": n, "k": k}
        reports = {
            "gaussian_adjoint_kept": {
                **shape, "ms": kept_ms, "ms_runs": runs["kept"], "plain_ms": plain_s * 1e3, "library_ms": lib_ms,
                "library_ms_runs": runs["library"], "library_host_us_per_call": lib_host_us,
                "bound_ms": kb_ms, "bound_by": kb_by, "bytes_floor_share": kb_ms / kept_ms,
                "max_abs_err": errs["gaussian_adjoint_kept"][1], "max_col_rel_err": errs["gaussian_adjoint_kept"][0],
                "tol": SX_TOL, "adjoint_identity_rel_err": ident, "rerun_bitwise": reruns["gaussian_adjoint_kept"],
                "bitwise_equal_redraw": bitwise, "max_col_rel_diff_redraw": kept_vs_redraw,
                "launches_per_call": launches["gaussian_adjoint_kept"], "host_us_per_call": host_us,
                "kept_s_bytes": 4 * S.numel()},
            "gaussian_adjoint": {
                **shape, "ms": redraw_ms, "ms_runs": runs["redraw"], "plain_ms": plain_s * 1e3, "library_ms": lib_ms,
                "bound_ms": rb_ms, "bound_by": rb_by, "max_abs_err": errs["gaussian_adjoint"][1],
                "max_col_rel_err": errs["gaussian_adjoint"][0], "tol": SX_TOL,
                "rerun_bitwise": reruns["gaussian_adjoint"], "launches_per_call": launches["gaussian_adjoint"]},
        }
        emit({"phase": "adjoint_kernel", **shape, "kept": reports["gaussian_adjoint_kept"],
              "redraw": reports["gaussian_adjoint"]})
        for name, rep in reports.items():
            check(rep["max_col_rel_err"] <= SX_TOL, f"{name} at {(m, n, k)} disagrees with its plain version")
            check(rep["rerun_bitwise"], f"{name} at {(m, n, k)} is not bitwise equal run to run")
            check(rep["launches_per_call"] == 1, f"{name} at {(m, n, k)} counted {rep['launches_per_call']} launches")
        check(ident <= SX_TOL, f"gaussian_adjoint_kept at {(m, n, k)}: <Sx, y> - <x, S^T y> off by {ident}")
        check(bitwise, f"gaussian_adjoint_kept at {(m, n, k)} is not bitwise the redraw kernel ({kept_vs_redraw})")
        sources = {"gaussian_adjoint_kept": "src/repro_torch/csrc/adjoint.cu",
                   "gaussian_adjoint": "src/repro_torch/csrc/adjoint.cu"}
        for name, rep in reports.items():
            if name not in rows:
                rows[name] = {"name": name, "route": "cuda", "source": sources[name], "replaces": ADJOINT_REPLACES,
                              "launches": 0, **rep, "other_shapes": []}
            else:
                rows[name]["other_shapes"].append(rep)
        del S, Sx
        torch.cuda.empty_cache()


def store_cost(key, X, m: int, label: str) -> dict:
    """Row 6 with and without the store of S, on X at m sketch rows: bitwise the
    same S·X, event ms interleaved (without, with, with, without, twice), the
    means. Two kept S are live at once before the timing, so the allocator holds
    the blocks a run of calls needs (a call's S is allocated while the last
    call's result is still held) and no timed call waits for a fresh one."""
    import torch

    from repro_torch.kernels.gaussian import ops

    plain = ops.gaussian_sketch(key, X, m)
    first, second = ops.gaussian_sketch_keep(key, X, m), ops.gaussian_sketch_keep(key, X, m)
    check(torch.equal(first[0], plain) and torch.equal(second[0], plain),
          f"gaussian_sketch at {label}: S·X with the store differs from S·X without it")
    del first, second
    reps = 3 if X.numel() >= 10**6 else 50
    runs = {"without": [], "with": []}
    for which in ("without", "with", "with", "without") * 2:
        fn = (lambda: ops.gaussian_sketch(key, X, m)) if which == "without" else \
            (lambda: ops.gaussian_sketch_keep(key, X, m))
        runs[which].append(cuda_ms(fn, reps)[0])
    without, with_store = (sum(runs[w]) / len(runs[w]) for w in ("without", "with"))
    report = {"shape": label, "n": X.shape[0], "d": X.shape[1], "m": m, "ms_without_store": without,
              "ms_with_store": with_store, "ratio": with_store / without, "runs": runs, "bitwise": True,
              "store_bytes": 4 * m * X.shape[0]}
    emit({"phase": "apply_store_cost", **report})
    return report


def phase_ln_apply(rows: dict) -> None:
    """The forward kernels at the shapes the least-norm paths give them, on
    Gaussian data: each S·A kernel (rows 6, 7, 12) on X = Aᵀ (d × n) and on the
    hybrid's m′ sampled rows of it, at FIG4A and, for the Gaussian, the Fig. 4(b)
    shape (eight column tiles); the FWHT (row 13b) on the SRHT's forward (Aᵀ
    zero-padded to next_pow2(d) and next_pow2(m′) rows) and on the one and 33
    columns its adjoint transforms (m sampled rows scattered into those); the
    fused SRHT forward (row 13a) on Aᵀ and its m′ rows, m sampled rows."""
    import torch

    from repro_torch.configs.paper_lsq import FIG4A
    from repro_torch.core import operators, sketches as sk
    from repro_torch.utils import prng

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    keys = prng.worker_keys(prng.prng_key(SEED + 7), 1)
    c = LN_FIG4B
    shapes = ((("gaussian",), c["d"], c["n"], c["m"], c["m_prime"], "fig4b"),
              (tuple(APPLY_ROUTES), FIG4A.d, FIG4A.n, FIG4A.m, FIG4A.m_prime, "fig4a"))
    for families, d, n, m, m_prime, tag in shapes:
        X = torch.randn((d, n), generator=g, device=DEVICE)
        for family in families:
            for label, rows_in in ((tag, d), (f"{tag}_hybrid", m_prime)):
                report = apply_check(family, keys, X[:rows_in].contiguous(), m, f"least_norm_{label}")
                if family == "gaussian" and rows_in == d:  # the least-norm forward keeps its S
                    report["with_store"] = store_cost(keys[0], X, m, f"least_norm_{label}")
                rows[APPLY_ROUTES[family][0]][f"least_norm_{label}"] = report
    del X
    torch.cuda.empty_cache()
    X = torch.randn((FIG4A.d, FIG4A.n), generator=g, device=DEVICE)
    for rows_in in (FIG4A.d, FIG4A.m_prime):
        n_pad = sk.next_pow2(rows_in)
        fwd = torch.zeros((n_pad, FIG4A.n), device=DEVICE)
        fwd[:rows_in] = X[:rows_in]
        shapes = [fwht_check(fwd)]
        for k in (1, 33):
            x = torch.zeros((n_pad, k), device=DEVICE)
            hit = torch.randint(0, n_pad, (FIG4A.m,), generator=g, device=DEVICE)
            x[hit] = torch.randn((FIG4A.m, k), generator=g, device=DEVICE)
            shapes.append(fwht_check(x))
        rows["fwht"].setdefault("least_norm_shapes", []).extend(shapes)
        kd, ids = operators.srht_params(keys[0], FIG4A.m, n_pad)
        rows["srht_forward"].setdefault("least_norm_shapes", []).append(
            srht_forward_check(kd, ids, X[:rows_in], n_pad))


def ln_problem(tag: str, n: int, d: int, seed: int):
    """A, b ~ N(0, 1) with n < d on the card, and x* = Aᵀ(AAᵀ)⁻¹b by a plain float64
    solve that the port does not use."""
    import torch

    from repro_torch.data import regression

    A, b, _ = regression.gaussian_regression(seed, n, d, planted=False, device=DEVICE)
    A64, b64 = A.double(), b.double()
    xstar, seconds = host_s(lambda: A64.T @ torch.linalg.solve(A64 @ A64.T, b64))
    emit({"phase": f"least_norm_exact_{tag}", "n": n, "d": d, "seconds": seconds})
    return A, b, xstar


def ln_spec(kind: str, m: int, m_prime: int, use_kernel: bool = True):
    """The spec of a least-norm path: SJLT s = 20, hybrid over m′ rows;
    "uniform_norep" samples without replacement."""
    from repro_torch.core import sketches as sk

    if kind.startswith("hybrid_"):
        return sk.SketchSpec("hybrid", m, m_prime=m_prime, inner=kind[7:], s=SJLT_S, use_kernel=use_kernel)
    if kind == "uniform_norep":
        return sk.SketchSpec("uniform", m, replacement=False)
    return sk.SketchSpec(kind, m, s=SJLT_S, use_kernel=use_kernel)


# Kernel calls per worker of a least-norm path with kernels on: one forward S·Aᵀ
# and, for the Gaussian, one adjoint over the S that forward kept (the redraw
# kernel only where S would not fit the scratch); the SRHT's fused forward and
# the FWHT of its adjoint. A hybrid makes its inner kind's calls; sampling makes none.
LN_KERNEL_CALLS = {"gaussian": {"gaussian_sketch": 1, "gaussian_adjoint_kept": 1},
                   "rademacher": {"rademacher_sketch": 1}, "srht": {"srht_forward": 1, "fwht": 1},
                   "sjlt": {"sjlt_apply": 1}}
LN_FIG4_KINDS = ("gaussian", "uniform_norep", "hybrid_gaussian")  # the paper's Fig. 4 sketches
LN_SIDE_KINDS = ("gaussian", "rademacher", "srht", "sjlt", "leverage", "uniform", "hybrid_gaussian",
                 "hybrid_rademacher", "hybrid_sjlt", "hybrid_srht")


def phase_least_norm(rows: dict) -> None:
    """The §V right-sketch least-norm paths, each twice (bitwise equal), gated on
    Lemma 7: the paper's Fig. 4 sketches at the Fig. 4(b) shape and FIG4A
    (q = 100), every kind at FIG4A (q = 8), and each kind that has a kernel also
    with ``use_kernel=False`` against its kernel path's x̄ of the same keys."""
    import torch

    from repro_torch.configs.paper_lsq import FIG4A
    from repro_torch.core import distributed
    from repro_torch.utils import prng

    key = prng.prng_key(SEED + 8)

    def path(label, kind, A, b, xstar, q, m, m_prime, use_kernel=True):
        calls = LN_KERNEL_CALLS.get(kind.removeprefix("hybrid_"), {}) if use_kernel else {}
        spec = ln_spec(kind, m, m_prime, use_kernel)
        solve = lambda: distributed.distributed_sketch_least_norm(spec, key, A, b, q=q, device=DEVICE)
        n, d = A.shape
        x, counts, _ = run_path(label, solve, {name: c * q for name, c in calls.items()}, lemma7(xstar, n, m, q),
                                LN_BAND.get(kind, LN_OTHER_BAND), twice=True, rows=rows, n=n, d=d, m=m)
        return x, counts, solve

    c = LN_FIG4B
    A, b, xstar = ln_problem("fig4b", c["n"], c["d"], SEED + 9)
    for kind in LN_FIG4_KINDS:
        _, counts, solve = path(f"least_norm_fig4b_{kind}", kind, A, b, xstar, c["q"], c["m"], c["m_prime"])
        if kind == "gaussian":
            rows["gaussian_adjoint_kept"]["launches"] = counts.get("gaussian_adjoint_kept", 0)
            phase_trace("least_norm_fig4b_gaussian_traced", solve)
    del A, b, xstar
    torch.cuda.empty_cache()

    A, b, xstar = ln_problem("fig4a", FIG4A.n, FIG4A.d, SEED + 10)
    shape = (A, b, xstar)
    for kind in LN_FIG4_KINDS:
        path(f"least_norm_fig4a_{kind}", kind, *shape, FIG4A.q, FIG4A.m, FIG4A.m_prime)
    q = LN_Q_SIDE
    for kind in LN_SIDE_KINDS:
        x_kernel, counts, _ = path(f"least_norm_fig4a_{kind}_q{q}", kind, *shape, q, FIG4A.m, FIG4A.m_prime)
        if kind == "srht":  # the SRHT adjoint's FWHT runs on this path alone
            rows["fwht"]["launches"] = counts.get("fwht", 0)
        if kind.removeprefix("hybrid_") not in LN_KERNEL_CALLS:
            continue
        x_plain, *_ = path(f"least_norm_fig4a_{kind}_plain", kind, *shape, q, FIG4A.m, FIG4A.m_prime,
                           use_kernel=False)
        rel = float((x_plain - x_kernel).abs().max() / x_kernel.abs().max())
        emit({"phase": "least_norm_plain_vs_kernel", "kind": kind, "q": q, "max_rel_diff": rel,
              "tol": LN_PLAIN_TOL})
        check(rel <= LN_PLAIN_TOL, f"least-norm {kind}: x̄ without kernels {rel} off the kernel path's x̄")
        if kind == "gaussian":
            x_redraw = ln_redraw_path(key, *shape, q, rows)
            rel = float((x_redraw - x_kernel).abs().max() / x_kernel.abs().max())
            emit({"phase": "least_norm_redraw_vs_kept", "q": q, "max_rel_diff": rel, "tol": LN_PLAIN_TOL})
            check(rel <= LN_PLAIN_TOL, f"least-norm gaussian: x̄ with S redrawn {rel} off the kept path's x̄")


def ln_redraw_path(key, A, b, xstar, q: int, rows: dict):
    """FIG4A's Gaussian least norm with a scratch one byte short of a worker's S
    (``cuda.keeps_sketch`` false, by the shapes): each worker's adjoint draws S
    again (the redraw kernel, row 5's standalone form). The smaller scratch may
    also cut the forward into fewer splits, so x̄ is held to the kept path's
    within LN_PLAIN_TOL, not bitwise."""
    from repro_torch.configs.paper_lsq import FIG4A
    from repro_torch.core import distributed
    from repro_torch.kernels import cuda

    spec = ln_spec("gaussian", FIG4A.m, FIG4A.m_prime)
    keep = cuda.SCRATCH_BYTES
    cuda.SCRATCH_BYTES = 4 * FIG4A.m * cuda.kept_sketch_ld(FIG4A.d) - 1
    try:
        check(not cuda.keeps_sketch(FIG4A.m, FIG4A.d), "the redraw path still keeps S")
        x, counts, _ = run_path(f"least_norm_fig4a_gaussian_redraw_q{q}",
                                lambda: distributed.distributed_sketch_least_norm(spec, key, A, b, q=q, device=DEVICE),
                                {"gaussian_sketch": q, "gaussian_adjoint": q}, lemma7(xstar, FIG4A.n, FIG4A.m, q),
                                LN_BAND["gaussian"], twice=True, rows=rows, n=FIG4A.n, d=FIG4A.d, m=FIG4A.m)
    finally:
        cuda.SCRATCH_BYTES = keep
    rows["gaussian_adjoint"]["launches"] = counts.get("gaussian_adjoint", 0)
    return x


# The serverless runtime and the solve server (repro_torch.runtime, repro_torch.serve):
# Algorithm 1 served as jobs whose tasks arrive under a latency model, on FIG3A's
# Gaussian data (and FIG4A's for the least-norm job), every task on the card.
SERVERLESS_BACKENDS = (("inline", 1, True), ("thread", 8, True), ("process", 2, False))  # pool width, rerun
EARLY_STOP_Q = 100  # the early-stop job's target: Theorem 1 at this many arrivals
SERVER_TOL = 1e-6  # a server job's x̄ against the synchronous solves of its arrivals: max |Δx| / max |x|
KILL_SHAPE = {"n": 4096, "d": 32, "m": 256, "q": 8, "victim": 3}
SERVE_CLI = ("--solve", "--q", "8", "--jobs", "2", "--backend", "thread")


def run_job(label: str, job, kernels: tuple, gate_at, band, rows: dict, *, twice: bool = False,
            traced: bool = False, call_ms: float | None = None, **fields):
    """Drive one runtime job (``job()`` returns a ``RuntimeResult``) with the counts
    at 0. Each kernel of ``kernels`` must be called once per arrival, and no other
    kernel (none in this process when ``kernels`` is empty: the process backend's
    children keep their counts). x̄ must be finite,
    its error at the realized q′ over the gate's within ``band``; with ``twice``
    a rerun must replay the log byte for byte and x̄ bitwise (with ``traced``, the
    rerun runs under ``torch.profiler``: ``phase_trace``'s line ``<label>_traced``
    gives the device's busy share, and seconds_rerun is the traced wall time). Reports the job's
    seconds, q′, retries, timeouts, drops, simulated makespan and, with
    ``call_ms`` (the one kernel's event time a call at this shape), the kernels'
    ms and the host loop's share of the seconds. Returns (result, report)."""
    import numpy as np
    import torch

    reset_counts()
    res, seconds = host_s(job)
    counts = read_counts()
    s = res.summary()
    gate = gate_at(res.count)
    rel = gate.error(torch.as_tensor(res.xbar, device=DEVICE))
    lo, hi = band or (1 / THEORY_FACTOR, THEORY_FACTOR)
    report = {"phase": label, **fields, "seconds": seconds, "q_effective": res.count, "submitted": res.submitted,
              "dispatched": res.dispatched, "retries": s["retries"], "timeouts": s["timeouts"], "drops": s["drops"],
              "cancelled": s["cancelled"], "stopped_early": res.stopped_early, "sim_makespan_s": s["sim_makespan_s"],
              "rel_err": rel, "law": gate.law, "theory": gate.pred, "ratio": rel / gate.pred, "ratio_band": [lo, hi],
              "launches": counts}
    if call_ms is not None:
        kernel_ms = counts.get(kernels[0], 0) * call_ms
        report.update(kernel_ms=kernel_ms, host_loop_share=1 - kernel_ms / (seconds * 1e3))
    if twice:
        res2, seconds2 = phase_trace(f"{label}_traced", job) if traced else host_s(job)
        report.update(seconds_rerun=seconds2, rerun_traced=traced,
                      rerun_log_identical=res2.events.lines() == res.events.lines(),
                      rerun_bitwise=bool(np.array_equal(res2.xbar, res.xbar)))
    emit(report)
    check(res.xbar.shape == (gate.d,) and bool(np.isfinite(res.xbar).all()), f"{label}: bad x̄")
    check_counts(label, counts, {k: res.count for k in kernels})
    check(not twice or (report["rerun_log_identical"] and report["rerun_bitwise"]),
          f"{label}: the rerun is not the same run")
    check(lo * gate.pred <= rel <= hi * gate.pred, f"{label}: error {rel} outside [{lo}, {hi}]× {gate.law}'s {gate.pred}")
    for k in kernels:
        if counts.get(k):
            rows[k].setdefault("launches_by_path", {})[label] = counts[k]
    return res, report


def phase_serverless(rows: dict) -> None:
    """The serverless runtime and the solve server on the card: FIG3A's SJLT job on
    the inline, thread and process backends (one log, one x̄); two Gaussian jobs
    through ``SolveServer`` (probe error, adaptive deadlines, drops) held against
    the synchronous solves of their arrivals; an early stop on Theorem 1; a
    least-norm job at FIG4A; the asynchronous multi-round mode; a killed worker;
    and the ``--solve`` launcher as a user runs it."""
    import numpy as np
    import torch

    from repro_torch import runtime as rt
    from repro_torch.configs.paper_lsq import FIG3A, FIG4A
    from repro_torch.core import distributed, sketches as sk, solve, theory
    from repro_torch.data import regression
    from repro_torch.serve import SolveServer
    from repro_torch.utils import prng

    cfg = FIG3A
    A, b, _ = regression.gaussian_regression(SEED, cfg.n, cfg.d, device=DEVICE)
    A64, b64 = A.double(), b.double()
    _, fstar = _exact(solve, A64, b64)
    key = prng.prng_key(SEED + 12)
    gate = lambda q: theorem1(A64, b64, fstar, cfg.m, q)
    sjlt = sk.SketchSpec("sjlt", cfg.m, s=SJLT_S, use_kernel=True)
    gauss = sk.SketchSpec("gaussian", cfg.m, use_kernel=True)

    # One SJLT job at q = 200 under a Pareto tail on each backend: one log, one x̄.
    heavy = rt.HeavyTailLatency(scale_s=0.5, alpha=1.5, seed=SEED)
    runs = {}
    for backend, width, twice in SERVERLESS_BACKENDS:
        conf = rt.RuntimeConfig(deadline_s=1.0, max_retries=2, backoff_base_s=0.05, max_threads=width)
        job = lambda: rt.serverless_sketch_solve(sjlt, key, A, b, q=cfg.q, latency=heavy, config=conf,
                                                 backend=backend, device=DEVICE)
        runs[backend], _ = run_job(f"serverless_fig3a_sjlt_{backend}", job,
                                   () if backend == "process" else ("sjlt_gram",), gate, THEORY_BAND["sjlt"], rows,
                                   twice=twice, traced=backend == "thread",
                                   call_ms=None if backend == "process" else rows["sjlt_gram"]["ms"],
                                   backend=backend, pool=width)
    ref = runs["inline"]
    same_log = {k: r.events.lines() == ref.events.lines() for k, r in runs.items()}
    bitwise = {k: bool(np.array_equal(r.xbar, ref.xbar)) for k, r in runs.items()}
    emit({"phase": "serverless_fig3a_sjlt", "q": cfg.q, "log_identical_to_inline": same_log,
          "xbar_bitwise_inline": bitwise, "first_attempt_timeouts": sum(
              1 for ev in ref.events if ev.kind == "timeout" and ev.attempt == 0)})
    check(all(same_log.values()) and all(bitwise.values()),
          f"serverless_fig3a_sjlt: backends differ (logs {same_log}, x̄ {bitwise})")

    # Two Gaussian jobs of one seed through the server: probe error, drops, adaptive deadlines.
    server = SolveServer(latency=rt.DropLatency(seed=SEED, inner=rt.LognormalLatency(seed=SEED, mean_s=0.4, sigma=0.6),
                                                drop_prob=0.2),
                         deadline=rt.AdaptiveDeadline(), device=DEVICE)
    job_seed = SEED + 13
    submit = lambda: server.submit_solve(A, b, gauss, q=cfg.q, seed=job_seed, error_fn="probe").result
    res, _ = run_job("serverless_fig3a_gaussian_server", submit, ("gaussian_gram",), gate, None, rows, twice=True,
                     traced=True, call_ms=rows["gaussian_gram"]["ms"], backend="thread")
    tele = server.telemetry()
    j0, j1 = server.jobs
    check(tele["jobs"] == 2 and tele["retries"] == j0.summary["retries"] + j1.summary["retries"]
          and tele["dispatched"] == 2 * res.dispatched, f"serverless_fig3a_gaussian_server: telemetry {tele}")
    # x̄ against the synchronous solves of the same arrivals: the first attempts through
    # the master's multi-key Gram over the realized mask, each retried arrival alone.
    jkey = prng.prng_key(job_seed)
    mask = j0.realized_mask
    first = distributed.distributed_sketch_solve_master(gauss, jkey, A, b, q=cfg.q, straggler_mask=mask,
                                                        device=DEVICE).double()
    retried = [(w, r) for w, r, attempt in res.arrived if attempt > 0]
    acc = first * float(mask.sum())
    for w, r in retried:
        acc = acc + solve.sketch_and_solve(gauss, prng.worker_key(jkey, w, r), A, b).double()
    want = (acc / res.count).cpu().numpy()
    diff = float(np.abs(j0.xbar - want).max() / np.abs(want).max())
    emit({"phase": "serverless_server_vs_synchronous", "first_attempts": int(mask.sum()),
          "retried_arrivals": len(retried), "max_rel_diff": diff, "tol": SERVER_TOL,
          "telemetry": {k: v for k, v in tele.items() if k != "per_job"},
          "final_error": [j.summary["final_error"] for j in server.jobs]})
    check(diff <= SERVER_TOL, f"serverless_fig3a_gaussian_server: x̄ {diff} off the synchronous solves")

    # Early stop on Theorem 1 at q' = 100: the rest are cancelled, and (inline) never computed.
    target = theory.gaussian_averaged_error(cfg.m, cfg.d, EARLY_STOP_Q)
    conf = rt.RuntimeConfig(deadline_s=10.0, max_retries=0, target_error=target)
    lat = rt.LognormalLatency(seed=SEED + 1, mean_s=0.4, sigma=0.6)
    res, _ = run_job("serverless_early_stop", lambda: rt.serverless_sketch_solve(
        gauss, key, A, b, q=cfg.q, latency=lat, config=conf, error_fn="theory", backend="inline", device=DEVICE),
        ("gaussian_gram",), gate, None, rows, call_ms=rows["gaussian_gram"]["ms"], backend="inline",
        target_error=target)
    check(res.stopped_early and res.count == EARLY_STOP_Q and res.events.counts().get("cancel") == cfg.q - EARLY_STOP_Q,
          f"serverless_early_stop: stopped {res.stopped_early} at q' = {res.count}")
    # The same job on the thread backend, the server's default: the same log and x̄.
    # Its pool computes in dispatch order while the master folds in arrival order,
    # so it may compute any task submitted before the stop, and no other.
    reset_counts()
    res_t, seconds = host_s(lambda: rt.serverless_sketch_solve(
        gauss, key, A, b, q=cfg.q, latency=lat, config=conf, error_fn="theory", backend="thread", device=DEVICE))
    counts = read_counts()
    stop = next(ev for ev in res_t.events if ev.kind == "stop")
    submitted = sum(1 for ev in res_t.events if ev.kind == "dispatch" and ev.seq < stop.seq
                    and (ev.extra["deadline_s"] is None or ev.extra["latency_s"] <= ev.extra["deadline_s"]))
    same = {"log": res_t.events.lines() == res.events.lines(), "xbar": bool(np.array_equal(res_t.xbar, res.xbar))}
    emit({"phase": "serverless_early_stop_thread", "seconds": seconds, "q_effective": res_t.count,
          "submitted_before_stop": submitted, "launches": counts, "identical_to_inline": same})
    check(all(same.values()), f"serverless_early_stop_thread: not the inline run ({same})")
    check(res_t.count <= counts.get("gaussian_gram", 0) <= submitted
          and not {k: c for k, c in counts.items() if c and k != "gaussian_gram"},
          f"serverless_early_stop_thread: launches {counts} outside [{res_t.count}, {submitted}]")

    # The asynchronous multi-round mode returns the engine's x̄.
    lat = rt.HeavyTailLatency(scale_s=0.5, alpha=1.5, seed=SEED + 3)
    conf = rt.RuntimeConfig(deadline_s=1.0, max_retries=2, backoff_base_s=0.05, backend="inline")
    reset_counts()
    x, seconds = host_s(lambda: distributed.distributed_sketch_solve_multiround(
        sjlt, key, A, b, q=MULTIROUND_Q, rounds=MULTIROUND_R, latency=lat, runtime_config=conf, device=DEVICE))
    counts = read_counts()
    res = rt.serverless_sketch_solve(sjlt, key, A, b, q=MULTIROUND_Q, rounds=MULTIROUND_R, latency=lat,
                                     config=conf, device=DEVICE)
    same = torch.equal(x.cpu(), torch.as_tensor(res.xbar, dtype=torch.float32))
    rel = gate(res.count).error(x)
    emit({"phase": "serverless_multiround_sjlt", "q": MULTIROUND_Q, "rounds": MULTIROUND_R, "seconds": seconds,
          "q_effective": res.count, "retries": res.summary()["retries"], "rel_err": rel,
          "ratio": rel / gate(res.count).pred, "ratio_band": list(THEORY_BAND["sjlt"]), "launches": counts,
          "bitwise_engine_xbar": same})
    check(same, "serverless_multiround_sjlt: x̄ is not the engine's")
    check_counts("serverless_multiround_sjlt", counts, {"sjlt_gram": res.count})
    lo, hi = THEORY_BAND["sjlt"]
    check(lo <= rel / gate(res.count).pred <= hi, f"serverless_multiround_sjlt: rel_err {rel} out of band")
    rows["sjlt_gram"].setdefault("launches_by_path", {})["serverless_multiround_sjlt"] = counts.get("sjlt_gram", 0)
    del A, b, A64, b64
    torch.cuda.empty_cache()

    # A least-norm job at FIG4A (q = 100): the S·A kernel keeps S, the adjoint reads it.
    A4, b4, xstar = ln_problem("serverless_fig4a", FIG4A.n, FIG4A.d, SEED + 14)
    server = SolveServer(latency=rt.LognormalLatency(seed=SEED + 2, mean_s=0.4, sigma=0.6),
                         config=rt.RuntimeConfig(deadline_s=0.8, max_retries=2), backend="inline", device=DEVICE)
    run_job("serverless_fig4a_least_norm", lambda: server.submit_solve(
        A4, b4, ln_spec("gaussian", FIG4A.m, FIG4A.m_prime), q=FIG4A.q, seed=SEED + 15, least_norm=True).result,
        ("gaussian_sketch", "gaussian_adjoint_kept"), lambda q: lemma7(xstar, FIG4A.n, FIG4A.m, q),
        LN_BAND["gaussian"], rows, twice=True, backend="inline")

    phase_killswitch(key)
    phase_serve_cli()


def phase_killswitch(key) -> None:
    """The process backend with one (worker, round) whose process is killed: that
    task becomes a drop, then a retry with a fresh round that arrives; each break
    builds one pool; x̄ is finite."""
    import numpy as np

    from repro_torch import runtime as rt
    from repro_torch.core import sketches as sk
    from repro_torch.data import regression

    c = KILL_SHAPE
    A, b, _ = regression.gaussian_regression(SEED + 16, c["n"], c["d"], device=DEVICE)
    compute = rt.make_sketch_solve_compute(sk.SketchSpec("sjlt", c["m"], s=SJLT_S, use_kernel=True), key, A, b,
                                           device=DEVICE)
    backend = rt.ProcessBackend(rt.KillSwitch(compute, kill_coords=((c["victim"], 0),)), max_workers=2)
    engine = rt.ServerlessEngine(compute, rt.ConstantLatency(value_s=0.1),
                                 rt.RuntimeConfig(deadline_s=1.0, max_retries=2), backend=backend)
    try:
        res, seconds = host_s(lambda: engine.run(q=c["q"]))
    finally:
        backend.shutdown()
    drops = [(ev.worker_id, ev.round_id) for ev in res.events if ev.kind == "drop"]
    retries = [(ev.worker_id, ev.round_id) for ev in res.events if ev.kind == "retry"]
    emit({"phase": "serverless_killswitch", **c, "seconds": seconds, "drops": drops, "retries": retries,
          "pools_built": backend.pools_built, "q_effective": res.count, "arrived": res.arrived,
          "finite": bool(np.isfinite(res.xbar).all())})
    check(drops == [(c["victim"], 0)] and len(retries) == 1 and retries[0][0] == c["victim"] and retries[0][1] >= 1,
          f"serverless_killswitch: drops {drops}, retries {retries}")
    # The victim breaks its pool and the one it is resubmitted to; the tasks queued
    # behind it go to the third pool without building another.
    check(backend.pools_built == 3, f"serverless_killswitch: {backend.pools_built} pools built for 2 breaks")
    check(res.count == c["q"] and bool(np.isfinite(res.xbar).all()), "serverless_killswitch: x̄ or q' wrong")


def phase_serve_cli() -> None:
    """``python -m repro_torch.launch.serve --solve`` as a user runs it, at its
    default shape: exit 0, one line a job and the aggregate line."""
    import os

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *SERVE_CLI], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    jobs = [line for line in lines if line.startswith("job ")]
    agg = [line for line in lines if line.startswith("backend=")]
    emit({"phase": "serve_cli", "args": list(SERVE_CLI), "returncode": out.returncode, "seconds": seconds,
          "lines": lines, "stderr_tail": out.stderr[-2000:] if out.returncode else ""})
    check(out.returncode == 0 and len(jobs) == 2 and len(agg) == 1, "serve_cli: the launcher failed")


# ------------------------------------------ Algorithm 1 across processes, gradient compression, head fitting

ROW_SHARDED_Q = 8  # workers of the row-sharded paths: blocks of 62,500 FIG3A rows
# Row-sharded workers (each sketches only its own n/q rows of A and b): the
# local-block estimator is not Theorem 1's, but on the planted Gaussian data it
# predicts about the same error (each worker's sketch error on its block; the
# blocks' own least-squares solutions scatter around the global one by a term
# ≈ q²d(m − d − 1)/n² of that, 1.4e-4 at FIG3A). With the JAX reference's
# workers composed on their own (A_w, b_w) on the CPU (tests/theory_ratio.py
# --row-sharded 500000 250 2500 8 1,2,3,4; PERF.md §6), rel_err /
# Theorem 1 at q = 8 was (least, most of 4 seeds; the band is [least/2, 2·most]):
ROW_SHARDED_RATIO = {"gaussian": (1.0033, 1.1278), "srht": (0.8166, 1.1328), "sjlt": (0.8760, 1.1675)}
GROUP_TOL = 1e-6  # a group's x̄ against the one-process x̄: max |Δx| / max |x|
SPAWN_TIMEOUT_S = 300
GRAD_SHAPES = {"w": (1 << 20,), "b": (1 << 16,)}  # benchmarks/gradcomp_bench.py's tree at its full size
GRAD_RATIOS = (0.01, 0.05, 0.1, 0.25)
GAUSS_RATIO = 0.01
FRESH_QS = (1, 4, 16)
FRESH_RATIO = 0.05
LONG_TOL = 1e-6  # row 12b against its plain version, per bucket: max |Δ| / Σ|terms|
GRAD_LARGE_D, GRAD_LARGE_RATIOS = 1 << 28, (0.01, 0.1, 0.25)
HEAD = {"n": 262_144, "d": 768, "k": 16, "q": 16, "m": 3072, "reg": 1e-4, "arrived": 12}
ROW12B = "src/repro/kernels/sjlt/kernel.py:25"


def phase_row_sharded_and_groups(rows: dict) -> None:
    """FIG3A's data in worker mode, q = 8: each worker sketching only its own
    62,500 rows of A and b (Gaussian, SRHT and SJLT: one fused single-key Gram a
    worker, twice, bitwise), the port's group of workers through
    ``init_worker_group``: NCCL with one rank in this process (worker, master
    and least-norm x̄ bitwise the ones without a group), then gloo with two
    spawned ranks sharing the card."""
    import torch

    from repro_torch.configs.paper_lsq import FIG3A
    from repro_torch.core import distributed, sketches as sk, solve
    from repro_torch.data import regression
    from repro_torch.utils import prng

    cfg, q = FIG3A, ROW_SHARDED_Q
    A, b, _ = regression.gaussian_regression(SEED + 18, cfg.n, cfg.d, device=DEVICE)
    A64, b64 = A.double(), b.double()
    _, fstar = _exact(solve, A64, b64)
    key = prng.prng_key(SEED + 18)
    gate = theorem1(A64, b64, fstar, cfg.m, q)
    sharded = {}
    for family in ("gaussian", "srht", "sjlt"):
        spec = sk.SketchSpec(family, cfg.m, s=SJLT_S, use_kernel=True)
        single = FAMILY_ROUTES[family][0]
        lo, hi = ROW_SHARDED_RATIO[family]
        sharded[family], _, _ = run_path(
            f"row_sharded_fig3a_{family}",
            lambda spec=spec: distributed.distributed_sketch_solve(spec, key, A, b, q=q, row_sharded=True,
                                                                   device=DEVICE),
            {single: q}, gate, (lo / 2, 2 * hi), twice=True, rows=rows, rows_per_worker=cfg.n // q,
            card=nvidia_smi_line())
    phase_group_nccl_world1(key, A, b, rows)
    phase_group_gloo_two_ranks(key, A, b, sharded["gaussian"], gate, rows)
    del A, b, A64, b64
    torch.cuda.empty_cache()


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_group_nccl_world1(key, A, b, rows: dict) -> None:
    """Worker, master and least-norm solves and the masked gradient mean (with
    compression off and on, a scalar mask) through ``init_worker_group``'s NCCL
    group of one rank (this process): each result bitwise the one without a
    group, its kernel calls the same."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.configs.paper_lsq import FIG3A, FIG4A
    from repro_torch.core import distributed, gradcomp, sketches as sk
    from repro_torch.launch import mesh
    from repro_torch.train import sketch_dp

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # a sealed machine: the loopback is the one interface
    (group, dev), init_s = host_s(lambda: mesh.init_worker_group(
        device=DEVICE, rank=0, world_size=1, init_method=f"tcp://localhost:{_free_port()}"))
    A4, b4, _ = ln_problem("group_nccl", FIG4A.n, FIG4A.d, SEED + 20)
    gauss = sk.SketchSpec("gaussian", FIG3A.m, use_kernel=True)
    sjlt = sk.SketchSpec("sjlt", FIG3A.m, s=SJLT_S, use_kernel=True)
    grads = _grads(SEED + 21, dev)
    uncompressed, countsketch = (gradcomp.GradCompressionConfig(enabled=on, ratio=0.1) for on in (False, True))
    paths = {
        "worker_gaussian": lambda g: distributed.distributed_sketch_solve(gauss, key, A, b, q=ROW_SHARDED_Q,
                                                                          device=dev, group=g),
        "master_sjlt": lambda g: distributed.distributed_sketch_solve_master(sjlt, key, A, b, q=FIG3A.q, device=dev,
                                                                             group=g),
        "least_norm_gaussian": lambda g: distributed.distributed_sketch_least_norm(
            ln_spec("gaussian", FIG4A.m, FIG4A.m_prime), key, A4, b4, q=FIG4A.q, device=dev, group=g),
        # no kernel: the mean of the leaves, the scalar mask reduced on the card
        "masked_mean_uncompressed": lambda g: sketch_dp.masked_compressed_mean(uncompressed, key, grads, 1.0, g),
        "masked_mean_countsketch": lambda g: sketch_dp.masked_compressed_mean(countsketch, key, grads, 1.0, g),
    }
    leaves = lambda x: list(x.values()) if isinstance(x, dict) else [x]
    report = {"phase": "group_nccl_world1", "card": nvidia_smi_line(), "backend": dist.get_backend(group),
              "world_size": dist.get_world_size(group), "device": str(dev), "init_seconds": init_s}
    try:
        for label, solve in paths.items():
            reset_counts()
            x_group, seconds = host_s(lambda: solve(group))
            counts_group = read_counts()
            reset_counts()
            x_none = solve(None)
            counts_none = read_counts()
            report[label] = {"seconds": seconds,
                             "bitwise_no_group": all(map(torch.equal, leaves(x_group), leaves(x_none))),
                             "finite": all(bool(torch.isfinite(v).all()) for v in leaves(x_group)),
                             "launches": counts_group,
                             "launches_no_group": counts_none}
    finally:
        dist.destroy_process_group()
    emit(report)
    for label in paths:
        r = report[label]
        check(r["bitwise_no_group"] and r["finite"], f"group_nccl_world1 {label}: x̄ not bitwise the one without a group")
        check(r["launches"] == r["launches_no_group"]
              and (sum(r["launches"].values()) > 0) == (label != "masked_mean_uncompressed"),
              f"group_nccl_world1 {label}: kernel calls {r['launches']} against {r['launches_no_group']}")
        for name, c in r["launches"].items():
            if c:
                rows[name].setdefault("launches_by_path", {})[f"group_nccl_world1_{label}"] = c


def _grads(seed: int, device, shapes=None) -> dict:
    """A gradient tree of N(0, 1) leaves drawn on ``device`` from ``seed``."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return {k: torch.randn(shape, generator=g, device=device) for k, shape in (shapes or GRAD_SHAPES).items()}


def _gloo_rank(rank: int, world: int, rendezvous: str, out_dir: str, device: str, shape: tuple,
               grad_shapes: dict, t_spawn: float) -> None:
    """One of the two spawned ranks of ``group_gloo_two_ranks``, both on ``device``,
    on FIG3A's data of ``shape`` (n, d, m). ``t_spawn``: the parent's wall clock
    at the spawn, for the seconds until this rank's group and data are ready."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed, gradcomp, sketches as sk
    from repro_torch.data import regression
    from repro_torch.launch import mesh
    from repro_torch.train import sketch_dp
    from repro_torch.utils import prng

    torch.backends.cuda.matmul.allow_tf32 = False
    group, dev = mesh.init_worker_group("gloo", device, rank=rank, world_size=world,
                                        init_method=f"file://{rendezvous}")
    n, d, m = shape
    A, b, _ = regression.gaussian_regression(SEED + 18, n, d, device=dev)
    key = prng.prng_key(SEED + 18)
    gauss = sk.SketchSpec("gaussian", m, use_kernel=True)
    rows_r = slice(rank * n // world, (rank + 1) * n // world)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    ready_seconds = time.time() - t_spawn

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, time.perf_counter() - t0

    out: dict = {"ready_seconds": ready_seconds}
    reset_counts()
    for label, solve in (
            ("replicated", lambda: distributed.distributed_sketch_solve(gauss, key, A, b, q=ROW_SHARDED_Q,
                                                                        device=dev, group=group)),
            ("row_sharded", lambda: distributed.distributed_sketch_solve(gauss, key, A[rows_r], b[rows_r],
                                                                         q=ROW_SHARDED_Q, row_sharded=True,
                                                                         device=dev, group=group))):
        (x1, s1), (x2, s2) = timed(solve), timed(solve)
        out[label] = {"x": x1.cpu(), "rerun_bitwise": torch.equal(x1, x2), "seconds": [s1, s2]}
    comp = gradcomp.GradCompressionConfig(enabled=True, ratio=0.1)
    g = _grads(SEED + 19 + rank, dev, grad_shapes)
    mean, seconds = timed(lambda: sketch_dp.masked_compressed_mean(comp, key, g, [1.0, 0.0][rank], group))
    out["masked_mean"] = {"leaves": {k: v.cpu() for k, v in mean.items()}, "seconds": seconds}
    out["launches"] = read_counts()
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def phase_group_gloo_two_ranks(key, A, b, x_row_sharded, gate, rows: dict) -> None:
    """Two spawned ranks, both on cuda:0, in one gloo group: FIG3A's Gaussian
    worker mode, q = 8 (4 workers a rank), replicated and row-sharded, and the
    masked, compressed gradient mean (mask [1, 0]); each x̄ within GROUP_TOL of
    the one-process x̄, bitwise on a rerun. NCCL takes one rank a device, so on a
    one-card machine this is the only run with more than one rank."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    from repro_torch.configs.paper_lsq import FIG3A
    from repro_torch.core import distributed, gradcomp, sketches as sk
    from repro_torch.train import sketch_dp

    work = ROOT / "build" / "group_gloo"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    args = (2, str(work / "rendezvous"), str(work), "cuda:0" if DEVICE == "cuda" else DEVICE,
            (A.shape[0], A.shape[1], FIG3A.m), GRAD_SHAPES, time.time())
    ctx = mp.start_processes(_gloo_rank, args=args, nprocs=2, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            check(time.perf_counter() - t0 < SPAWN_TIMEOUT_S, f"group_gloo_two_ranks: ranks past {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    seconds = time.perf_counter() - t0
    res = [torch.load(work / f"rank{r}.pt") for r in range(2)]
    shutil.rmtree(work, ignore_errors=True)
    gauss = sk.SketchSpec("gaussian", FIG3A.m, use_kernel=True)
    want = {"replicated": distributed.distributed_sketch_solve(gauss, key, A, b, q=ROW_SHARDED_Q, device=DEVICE).cpu(),
            "row_sharded": x_row_sharded.cpu()}
    comp = gradcomp.GradCompressionConfig(enabled=True, ratio=0.1)
    g0 = _grads(SEED + 19, DEVICE)
    want_mean = {k: v.cpu() for k, v in sketch_dp.masked_compressed_mean(comp, key, g0, 1.0).items()}
    rel = lambda x, w: float((x.double() - w.double()).abs().max() / w.double().abs().max())
    report = {"phase": "group_gloo_two_ranks", "card": nvidia_smi_line(), "ranks": 2, "device": "cuda:0",
              "seconds_whole": seconds, "ready_seconds": [r["ready_seconds"] for r in res]}
    for label in ("replicated", "row_sharded"):
        report[label] = {"max_rel_diff": [rel(r[label]["x"], want[label]) for r in res],
                         "rerun_bitwise": [r[label]["rerun_bitwise"] for r in res],
                         "ranks_bitwise": torch.equal(res[0][label]["x"], res[1][label]["x"]),
                         "seconds": [r[label]["seconds"] for r in res], "rel_err": gate.error(res[0][label]["x"].to(DEVICE)),
                         "theory": gate.pred}
    report["masked_mean"] = {"max_rel_diff": [max(rel(r["masked_mean"]["leaves"][k], want_mean[k]) for k in want_mean)
                                              for r in res],
                             "bitwise_one_process": [all(torch.equal(r["masked_mean"]["leaves"][k], want_mean[k])
                                                         for k in want_mean) for r in res],
                             "seconds": [r["masked_mean"]["seconds"] for r in res]}
    report["launches"] = [r["launches"] for r in res]
    emit(report)
    for label in ("replicated", "row_sharded"):
        r = report[label]
        check(max(r["max_rel_diff"]) <= GROUP_TOL and all(r["rerun_bitwise"]) and r["ranks_bitwise"],
              f"group_gloo_two_ranks {label}: {r}")
    check(max(report["masked_mean"]["max_rel_diff"]) <= GROUP_TOL, f"group_gloo_two_ranks masked mean: {report}")
    for counts in report["launches"]:
        # 4 workers a rank on each of the two paths, each run twice; one compress
        check_counts("group_gloo_two_ranks", counts, {"gaussian_gram": 16, "sjlt_apply_long": 1})


def long_bucket_err(key, X, m: int, s: int, got, want) -> float:
    """Row 12b's measure: per (bucket, column), |Δ| over the Σ|terms| of that
    entry (float64, from the same pairs)."""
    import torch

    from repro_torch.kernels import common

    k0, k1 = common.key_words(key)
    n, d = X.shape
    mass = torch.zeros((m, d), dtype=torch.float64, device=X.device)
    for j0 in range(0, n, 1 << 22):
        blk = X[j0 : j0 + (1 << 22)]
        buckets, _ = common.sjlt_counter_params(k0, k1, j0 + torch.arange(blk.shape[0], device=X.device), s, m)
        mass.index_add_(0, buckets.reshape(-1), blk.double().abs().repeat_interleave(s, dim=0) * common.inv_sqrt(s))
    return float(((got.double() - want.double()).abs() / mass.clamp_min(1e-300)).max())


def long_library(key, X, m: int, s: int):
    """Row 12b's yardstick: one ``index_add_`` of the signed entries (n·s, d),
    built before any timing, into (m, d) (float atomics: not deterministic).
    Returns ``run()``; the port never calls it."""
    import torch

    from repro_torch.kernels import common

    k0, k1 = common.key_words(key)
    n, d = X.shape
    idx = torch.empty(n * s, dtype=torch.int64, device=X.device)
    src = torch.empty((n * s, d), dtype=torch.float32, device=X.device)
    for j0 in range(0, n, 1 << 22):
        blk = X[j0 : j0 + (1 << 22)]
        buckets, signs = common.sjlt_counter_params(k0, k1, j0 + torch.arange(blk.shape[0], device=X.device), s, m)
        idx[j0 * s : (j0 + blk.shape[0]) * s] = buckets.reshape(-1)
        src[j0 * s : (j0 + blk.shape[0]) * s] = (signs[..., None] * blk[:, None, :]).reshape(-1, d)
    return lambda: torch.zeros((m, d), dtype=torch.float32, device=X.device).index_add_(0, idx, src)


def phase_gradcomp(rows: dict) -> None:
    """Sketched gradient compression at gradcomp_bench's full size, D = 2^20 + 2^16:
    CountSketch at four ratios through row 12b (the long-column SJLT S·A), one
    call a compress, its payload against the plain version on the same card
    tensors and its error against E‖SᵀSg − g‖² = (D − 1)‖g‖²/m; the Gaussian at
    1% through rows 6 and 5b, against (D + 1)‖g‖²/m and its plain version on a
    slice; the fresh-sketch mean of q = 1, 4, 16 reconstructions, its error² at
    1/q. Then row 12b at D = 2^28 (``gradcomp_large``)."""
    import math

    import torch

    from repro_torch.core import gradcomp
    from repro_torch.kernels import common
    from repro_torch.kernels.gaussian import ops as gops, ref as gref
    from repro_torch.kernels.sjlt import ops as sops, ref as sref
    from repro_torch.utils import prng, tree as tu

    g = _grads(SEED + 21, DEVICE)
    vec, _ = tu.tree_flatten_to_vector(g)
    D = vec.shape[0]
    X = vec[:, None].contiguous()
    key = prng.prng_key(SEED + 21)
    card = nvidia_smi_line()
    cs = {r: gradcomp.GradCompressionConfig(enabled=True, ratio=r) for r in GRAD_RATIOS}
    # The main path of row 12b: every CountSketch compress of this phase, counted.
    reset_counts()
    errs, seconds = {}, {}
    for r, cfg in cs.items():
        err, seconds[r] = host_s(lambda cfg=cfg: gradcomp.compression_error(cfg, key, g))
        errs[r] = float(err)
    payloads = {r: gradcomp.compress(cfg, key, g)[0] for r, cfg in cs.items()}
    fresh = {}
    for q in FRESH_QS:
        cfg = gradcomp.GradCompressionConfig(enabled=True, ratio=FRESH_RATIO)
        recs = [gradcomp.decompress(cfg, *gradcomp.compress(cfg, prng.fold_in(key, w), g)) for w in range(q)]
        mean = tu.tree_map(lambda *xs: sum(xs) / q, *recs)
        fresh[q] = float(tu.tree_global_norm(tu.tree_map(torch.subtract, mean, g)) / tu.tree_global_norm(g))
    counts = read_counts()
    calls = 2 * len(GRAD_RATIOS) + sum(FRESH_QS)
    check_counts("gradcomp_bench_size", counts, {"sjlt_apply_long": calls})
    report = {"phase": "gradcomp_bench_size", "card": card, "D": D, "launches": counts, "countsketch": {}}
    for r, cfg in cs.items():
        m = max(1, math.ceil(r * D))
        kept = kept_adjoint_report(cfg, key, g, D)
        want, plain_s = host_s(lambda m=m: sref.sketch(key, X, m, 1))
        err = long_bucket_err(key, X, m, 1, payloads[r][:, None], want)
        ms, _ = cuda_ms(lambda m=m: sops.sjlt_apply(key, X, m, 1), 5)
        library = long_library(key, X, m, 1)
        lib_ms, _ = cuda_ms(library, 5)
        del library
        bound, by = bound_ms("sjlt", D, 1, m, 1, s=1, apply=True)
        report["countsketch"][str(r)] = {
            "m": m, "seconds_error": seconds[r], "rel_err": errs[r], "err2_m_over_D_minus_1": errs[r] ** 2 * m / (D - 1),
            "per_bucket_rel_err": err, "max_abs_err": float((payloads[r][:, None] - want).abs().max()),
            "tol": LONG_TOL, "ms": ms, "plain_ms": plain_s * 1e3, "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": by, "rerun_bitwise": torch.equal(gradcomp.compress(cfg, key, g)[0], payloads[r]), **kept}
    r10 = report["countsketch"]["0.1"]
    rows["sjlt_apply_long"] = {
        "name": "sjlt_apply_long", "row": "12b", "route": "cuda", "source": "src/repro_torch/csrc/sjlt_gram.cu",
        "replaces": ROW12B, "launches": counts.get("sjlt_apply_long", 0), "max_abs_err": r10["max_abs_err"],
        "per_bucket_rel_err": r10["per_bucket_rel_err"], "ms": r10["ms"], "plain_ms": r10["plain_ms"],
        "bound_ms": r10["bound_ms"], "bound_by": r10["bound_by"], "library_ms": r10["library_ms"],
        "shape": {"n": D, "d": 1, "m": r10["m"], "s": 1},
        "launches_by_path": {"gradcomp_bench_size": counts.get("sjlt_apply_long", 0)}}
    # The Gaussian at 1%: rows 6 and 5b; the plain version on the first sketch rows
    # and output rows (a whole plain S is m·D = 1.2e10 entries).
    cfg = gradcomp.GradCompressionConfig(enabled=True, ratio=GAUSS_RATIO, kind="gaussian")
    m = max(1, math.ceil(GAUSS_RATIO * D))
    gops.LAUNCHES.clear()
    (payload, ctx), compress_s = host_s(lambda: gradcomp.compress(cfg, key, g))
    rec, decompress_s = host_s(lambda: gradcomp.decompress(cfg, payload, ctx))
    gcounts = {k: v for k, v in gops.LAUNCHES.items() if v}
    k0, k1 = common.key_words(key)
    head = min(256, m)
    with common.full_fp32_matmul():
        want_p = gref.sketch(key, X, head) * (common.inv_sqrt(m) / common.inv_sqrt(head))
        want_r = gref.columns(k0, k1, m, 0, 4096, X.device).double().T @ payload.double()
    rec_vec, _ = tu.tree_flatten_to_vector(rec)
    gerr = float(tu.tree_global_norm(tu.tree_map(torch.subtract, rec, g)) / tu.tree_global_norm(g))
    report["gaussian"] = {
        "m": m, "compress_seconds": compress_s, "decompress_seconds": decompress_s, "launches": gcounts,
        "rel_err": gerr, "err2_m_over_D_plus_1": gerr ** 2 * m / (D + 1),
        "payload_head_rel_err": sx_err(payload[:head, None], want_p),
        "reconstruction_head_rel_err": sx_err(rec_vec[:4096, None], want_r[:, None]), "tol": SX_TOL}
    report["fresh_sketch"] = {"ratio": FRESH_RATIO, "rel_err": {str(q): e for q, e in fresh.items()},
                              "err2_times_q_over_q1": {str(q): e ** 2 * q / fresh[1] ** 2 for q, e in fresh.items()}}
    emit(report)
    for r, c in report["countsketch"].items():
        check(0.9 <= c["err2_m_over_D_minus_1"] <= 1.1, f"gradcomp countsketch {r}: error² {c}")
        check(c["per_bucket_rel_err"] <= LONG_TOL and c["rerun_bitwise"], f"gradcomp countsketch {r}: payload {c}")
        check(c["kept_adjoint_bitwise"] and c["kept_adjoint_launches"] == {"sjlt_apply_long": 1},
              f"gradcomp countsketch {r}: the kept adjoint {c}")
    gr = report["gaussian"]
    check(gcounts == {"gaussian_sketch": 1, "gaussian_adjoint": 1}, f"gradcomp gaussian: launches {gcounts}")
    check(0.9 <= gr["err2_m_over_D_plus_1"] <= 1.1, f"gradcomp gaussian: error² {gr}")
    check(gr["payload_head_rel_err"] <= SX_TOL and gr["reconstruction_head_rel_err"] <= SX_TOL,
          f"gradcomp gaussian: off its plain version {gr}")
    for q, v in report["fresh_sketch"]["err2_times_q_over_q1"].items():
        check(0.7 <= v <= 1.4, f"gradcomp fresh-sketch mean at q = {q}: error² · q / error²(1) = {v}")
    for name, c in gcounts.items():
        rows[name].setdefault("launches_by_path", {})["gradcomp_gaussian"] = c
    del g, vec, X, payloads
    torch.cuda.empty_cache()
    phase_gradcomp_large(rows)


def kept_adjoint_report(cfg, key, g, D: int) -> dict:
    """One CountSketch compress and decompress of the gradient tree g (D
    coordinates) on the card, timed, with the peak device memory over the
    pair: decompress's adjoint reads the pair list the compress kept
    (``operators.sjlt_adjoint_kept``). Then that adjoint (``ctx[0]``) beside
    the one that draws the pairs again (``SJLTOp.adjoint``), each timed with
    CUDA events on the payload and held bitwise against the other, and the
    calls of the compress into row 12b."""
    import torch

    from repro_torch.core import gradcomp, operators
    from repro_torch.core.sketches import SketchSpec
    from repro_torch.kernels.sjlt import ops as sops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = dict(sops.LAUNCHES)
    (payload, ctx), compress_s = host_s(lambda: gradcomp.compress(cfg, key, g))
    launches = {k: v - before.get(k, 0) for k, v in sops.LAUNCHES.items() if v != before.get(k, 0)}
    rec, decompress_s = host_s(lambda: gradcomp.decompress(cfg, payload, ctx))
    peak = torch.cuda.max_memory_allocated() - base
    del rec
    kept_adjoint = ctx[0]
    op = operators.make_operator(SketchSpec("sjlt", payload.shape[0], s=1), key, D, device=payload.device)
    kept_ms, kept = cuda_ms(lambda: kept_adjoint(payload), 2)
    # one run, warmed up below 2^24 coordinates (at 2^28 a redraw takes 0.6 s)
    redraw_ms, redrawn = cuda_ms(lambda: op.adjoint(payload), 1, warmup=D < 1 << 24)
    return {"compress_seconds": compress_s, "decompress_seconds": decompress_s, "peak_bytes": peak,
            "kept_adjoint_ms": kept_ms, "redraw_adjoint_ms": redraw_ms,
            "kept_adjoint_bitwise": bool(torch.equal(kept, redrawn)), "kept_adjoint_launches": launches}


def phase_gradcomp_large(rows: dict) -> None:
    """CountSketch of one D = 2^28 gradient (1.07 GB of float32) at ratios
    0.01, 0.1 and 0.25: row 12b's event time against its bound and the
    library's ``index_add_``, the whole compress + decompress with its peak
    memory, and decompress's adjoint over the kept pair list beside the one
    that draws the pairs again."""
    import math

    import torch

    from repro_torch.core import gradcomp
    from repro_torch.kernels.sjlt import ops as sops
    from repro_torch.utils import prng

    D = GRAD_LARGE_D
    g = _grads(SEED + 22, DEVICE, {"w": (D,)})
    key = prng.prng_key(SEED + 22)
    X = g["w"][:, None]
    card = nvidia_smi_line()
    large = {}
    for ratio in GRAD_LARGE_RATIOS:
        cfg = gradcomp.GradCompressionConfig(enabled=True, ratio=ratio)
        m = max(1, math.ceil(ratio * D))
        kept = kept_adjoint_report(cfg, key, g, D)
        payload, ctx = gradcomp.compress(cfg, key, g)
        rec = gradcomp.decompress(cfg, payload, ctx)
        err = float(torch.linalg.norm(rec["w"].double() - g["w"].double()) / torch.linalg.norm(g["w"].double()))
        del rec, ctx
        ms, out = cuda_ms(lambda m=m: sops.sjlt_apply(key, X, m, 1), 3)
        rerun = torch.equal(out[:, 0], payload)
        library = long_library(key, X, m, 1)
        lib_ms, lib_out = cuda_ms(library, 3)
        lib_err = long_bucket_err(key, X, m, 1, out, lib_out)
        del library, lib_out, out, payload
        bound, by = bound_ms("sjlt", D, 1, m, 1, s=1, apply=True)
        report = {"phase": "gradcomp_large", "card": card, "D": D, "m": m, "ratio": ratio, "ms": ms,
                  "bound_ms": bound, "bound_by": by, "library_ms": lib_ms, "library_per_bucket_rel_diff": lib_err,
                  **kept, "rel_err": err, "err2_m_over_D_minus_1": err ** 2 * m / (D - 1), "rerun_bitwise": rerun}
        emit(report)
        large[str(ratio)] = {k: report[k] for k in ("D", "m", "ms", "bound_ms", "bound_by", "library_ms",
                                                    "compress_seconds", "decompress_seconds", "peak_bytes",
                                                    "kept_adjoint_ms", "redraw_adjoint_ms")}
        check(0.9 <= report["err2_m_over_D_minus_1"] <= 1.1 and rerun, f"gradcomp_large {ratio}: {report}")
        # the library adds in float32 with atomics, in an order that changes: its
        # rounding (≤ L·2⁻²⁴ of Σ|terms|, L ≈ 1/ratio pairs a bucket) bounds the gap
        check(lib_err <= 1e-5, f"gradcomp_large {ratio}: off the library's index_add_ by {lib_err}")
        check(report["kept_adjoint_bitwise"] and report["kept_adjoint_launches"] == {"sjlt_apply_long": 1},
              f"gradcomp_large {ratio}: the kept adjoint {report}")
        torch.cuda.empty_cache()
    rows["sjlt_apply_long"]["large"] = large
    del g, X
    torch.cuda.empty_cache()


def phase_fit_head(rows: dict) -> None:
    """Linear-head fitting at whisper-small's width: features H (262,144 tokens ×
    d_model 768), 16 outputs Y = HW + 0.1·noise, q = 16 workers of m = 3,072 with a
    straggler mask keeping 12, reg = 1e-4; the Gaussian through row 2 and the
    SJLT (s = 20) through row 11, one multi-key Gram for the 16 workers (in
    ``cuda.worker_chunk`` calls). ``head_fit_quality``'s rel_err within a factor
    3 of Theorem 1 at q′ = 12; 16 disclosures to the accountant."""
    import torch

    from repro_torch.core import privacy, sketches as sk, theory
    from repro_torch.kernels import cuda
    from repro_torch.train import solvers
    from repro_torch.utils import prng

    c = HEAD
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    H = torch.randn((c["n"], c["d"]), generator=gen, device=DEVICE)
    W = torch.randn((c["d"], c["k"]), generator=gen, device=DEVICE)
    Y = H @ W + 0.1 * torch.randn((c["n"], c["k"]), generator=gen, device=DEVICE)
    mask = torch.zeros(c["q"])
    mask[torch.randperm(c["q"], generator=torch.Generator().manual_seed(SEED + 23))[: c["arrived"]]] = 1.0
    pred = theory.gaussian_averaged_error(c["m"], c["d"], c["arrived"])
    key = prng.prng_key(SEED + 23)
    dx = c["d"] + c["k"]
    for family in ("gaussian", "sjlt"):
        spec = sk.SketchSpec(family, c["m"], s=SJLT_S, use_kernel=True)
        multi = FAMILY_ROUTES[family][1]
        calls = -(-c["q"] // cuda.worker_chunk(c["n"], c["m"], dx, c["q"], family=family, s=SJLT_S))
        acc = privacy.PrivacyAccountant()
        reset_counts()
        Wh, seconds = host_s(lambda: solvers.fit_head(key, H, Y, spec, q=c["q"], reg=c["reg"], straggler_mask=mask,
                                                      accountant=acc, device=DEVICE))
        counts = read_counts()
        quality = solvers.head_fit_quality(H, Y, Wh)
        label = f"fit_head_whisper_width_{family}"
        emit({"phase": label, "card": nvidia_smi_line(), **c, "seconds": seconds, "launches": counts,
              **quality, "theory": pred, "ratio": quality["rel_err"] / pred, "ratio_band": [1 / THEORY_FACTOR, THEORY_FACTOR],
              "disclosures": len(acc.disclosures), "gamma": acc.disclosures[0].gamma,
              "total_per_entry_nats": acc.total_per_entry_nats})
        check(tuple(Wh.shape) == (c["d"], c["k"]) and bool(torch.isfinite(Wh).all()), f"{label}: bad W")
        check_counts(label, counts, {multi: calls})
        check(pred / THEORY_FACTOR <= quality["rel_err"] <= THEORY_FACTOR * pred,
              f"{label}: rel_err {quality['rel_err']} outside 3× Theorem 1's {pred}")
        check(len(acc.disclosures) == c["q"], f"{label}: {len(acc.disclosures)} disclosures")
        rows[multi].setdefault("launches_by_path", {})[label] = counts.get(multi, 0)
    del H, W, Y
    torch.cuda.empty_cache()

def phase_trace(label: str, solve) -> None:
    """One more run of a path under ``torch.profiler``: device time by kernel and the
    device's busy share of the run's wall time (kernels on one stream, so their
    times add). The untraced runs give the end-to-end numbers. Returns the path's
    output and the traced run's wall seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = solve()
        enqueued = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0][:80]
            by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    # A session that recorded no device activity measured nothing: say so, not 0.
    seen = bool(by_kernel)
    emit({"phase": label, "wall_ms": wall * 1e3, "host_enqueue_ms": enqueued * 1e3,
          "device_busy_ms": busy_ms if seen else None,
          "device_busy_share": busy_ms / (wall * 1e3) if seen else None, "device_kernels": len(by_kernel),
          "top_kernels_ms": top})
    return out, wall


def _exact(solve, A64, b64):
    xstar = solve.lstsq(A64, b64, method="qr")
    return xstar, solve.residual_cost(A64, b64, xstar)


def main() -> int:
    import torch

    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.paper_lsq import FIG3A
    from repro_torch.data import regression

    smi = nvidia_smi_line()
    print(smi, flush=True)
    try:
        phase_build()
        phase_rng_probe()
        phase_tensor_cores()
        A, b, _ = regression.gaussian_regression(SEED + 2, FIG3A.n, FIG3A.d, device=DEVICE)
        rows: dict = {}
        X = torch.cat([A, b[:, None]], dim=1)
        del A, b
        phase_kernels(X, FIG3A.m, rows)
        phase_apply_kernels(X, FIG3A.m, FIG3A.m_prime, rows)
        phase_fwht(X, FIG3A.m, FIG3A.m_prime, rows)
        phase_row_offsets(X, FIG3A.m, rows)
        del X
        torch.cuda.empty_cache()
        phase_main_path(FIG3A, rows)
        phase_fig3a_student_t(FIG3A, rows)
        phase_fig2_emnist(rows)
        phase_adjoint_kernel(rows)
        phase_ln_apply(rows)
        phase_least_norm(rows)
        phase_gradcomp(rows)
        phase_fit_head(rows)
        phase_serverless(rows)
        phase_row_sharded_and_groups(rows)
        for name, row in rows.items():
            check(row["launches"] > 0, f"{name} was not launched on its path")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"kernels": list(rows.values())})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
