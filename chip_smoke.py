#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source,
in parallel), checks the device counter RNG against the plain PyTorch contract,
holds each sketch→Gram kernel (Gaussian, Rademacher, SRHT, SJLT with FIG3A's
s = 20) against its plain version at the FIG3A shape (n = 500,000, d = 250,
m = 2,500), q = 1 and 2, and each S·A kernel (Gaussian, Rademacher, SJLT) and
the FWHT kernel at the shapes of their paths (the hybrid's m′ = 25,000 rows, the
two-pass path's full n; the FWHT on 2^19 and 2^15 rows), then runs Algorithm 1
end to end:

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
n < d): the Gaussian adjoint kernel against its plain version at the shapes its
paths give it, and so each S·A kernel at X = Aᵀ and on the hybrid's m′ rows of
it, and the FWHT on the SRHT's forward and adjoint (one and 33 columns); then
the paths, each twice and bitwise equal: FIG4A (n = 50, d = 1,000, m = 200,
m′ = 500) and the Fig. 4(b) shape (n = 2,000, d = 11,556, m = 4,000, m′ = 8,000)
at q = 100 with the Gaussian, uniform sampling without replacement and the
hybrid with the Gaussian inside (the paper's Fig. 4 sketches); every kind at
FIG4A, q = 8, each kind with a kernel also with ``use_kernel=False`` against the
kernel path's x̄. Each is gated on ‖x̄ − x*‖²/‖x*‖² over Lemma 7's
(d − n)/(q(m − n − 1)), x* from a plain float64 solve.

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
PEAK_INT32_OPS = 16.7e12
PEAK_BYTES = 3.35e12
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


def fwht_bound_ms(n: int, k: int) -> tuple[float, str]:
    """Least time for H·x, x (n, k) float32: x read once and H·x written once, or
    the log2(n) stages of one add or subtract per element each, at the fp32 peak."""
    bytes_ms = 8 * n * k / PEAK_BYTES * 1e3
    ops_ms = n * k * (n.bit_length() - 1) / PEAK_FP32_FLOPS * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


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
    ptxas = [
        line.strip() for b in built for line in b.log.splitlines()
        if "registers" in line or "spill" in line
    ]
    emit({"phase": "build", "seconds": seconds,
          "libraries": {b.name: b.seconds for b in built}, "ptxas": ptxas})


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
            b_ms, b_by = bound_ms(family, n, dx, m, q, rounds)
            rows[name] = {
                "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{SOURCES[family]}",
                "replaces": src, "launches": 0, "max_abs_err": abs_err, "max_entry_rel_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms, "shape": {"n": n, "d": dx, "m": m, "q": q},
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
    card, plain and library ms and its bound. Emits one ``apply_kernels`` line."""
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
    lib_ms, _ = cuda_ms(lambda: library(1), 3)
    del library
    torch.cuda.empty_cache()
    ms, _ = cuda_ms(lambda: calls.single(0, Y), 3)
    rounds = common.rng_rounds() if family == "gaussian" else common.DEFAULT_ROUNDS
    b_ms, b_by = bound_ms(family, ny, dx, m, 1, rounds, apply=True)
    report = {"n": ny, "d": dx, "m": m, "ms": ms, "plain_ms": plain_s * 1e3, "library_ms": lib_ms,
              "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": abs_err, "max_col_rel_err": err,
              "tol": SX_TOL, "rerun_bitwise": rerun}
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
            "name": single, "route": "cuda", "source": f"src/repro_torch/csrc/{SOURCES[family]}",
            "replaces": src, "launches": 0, "max_abs_err": h["max_abs_err"],
            "max_col_rel_err": h["max_col_rel_err"], "ms": h["ms"], "plain_ms": h["plain_ms"],
            "bound_ms": h["bound_ms"], "bound_by": h["bound_by"], "library_ms": h["library_ms"],
            "shape": {"n": m_prime, "d": dx, "m": m, "q": 1}, "full_n": report["full"],
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
        b_ms, b_by = bound_ms(family, n, dx, m, CHECK_Q, rounds, apply=True)
        rows[multi] = {
            "name": multi, "route": "cuda", "source": f"src/repro_torch/csrc/{SOURCES[family]}",
            "replaces": src, "launches": 0, "max_abs_err": abs_m, "max_col_rel_err": err_m,
            "ms": ms_m, "plain_ms": plain_s * 1e3, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "shape": {"n": n, "d": dx, "m": m, "q": CHECK_Q},
        }
        # The first worker-chunk edge of the multi-key entry at this shape.
        chunk = cuda.worker_chunk(n, m, dx, 1 << 20, family=family, s=SJLT_S)
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


def phase_fwht(X, m_prime: int, rows: dict) -> None:
    """The FWHT kernel against its plain version, bitwise, on the rows the SRHT
    transforms: X zero-padded to the two-pass path's n_pad (2^19 at FIG3A), and
    X's first m′ rows zero-padded to the hybrid's (next_pow2(m′) = 2^15)."""
    import torch

    from repro_torch.core import sketches as sk

    n, dx = X.shape
    for rows_in in (n, m_prime):
        n_pad = sk.next_pow2(rows_in)
        x = torch.zeros((n_pad, dx), dtype=torch.float32, device=X.device)
        x[:rows_in] = X[:rows_in]
        r = fwht_check(x)
        if "fwht" not in rows:
            rows["fwht"] = {
                "name": "fwht", "route": "cuda", "source": "src/repro_torch/csrc/fwht.cu",
                "replaces": FWHT_REPLACES, "launches": 0, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None, "shape": {"n_pad": n_pad, "d": dx},
            }
        else:
            rows["fwht"]["hybrid_shape"] = {"n_pad": n_pad, "ms": r["ms"], "plain_ms": r["plain_ms"],
                                            "bound_ms": r["bound_ms"]}


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
    """What a path's x̄ (d,) is held to: ``error(x̄)`` over ``pred``, the prediction
    of ``law`` for q averaged workers, within a band."""
    d: int
    q: int
    pred: float
    error: Callable
    law: str


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
    check(tuple(xbar.shape) == (gate.d,) and bool(torch.isfinite(xbar).all()), f"{label}: bad x̄")
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
    b_ms, b_by = bound_ms(family, n, dx, m, q, rounds)
    rows[multi].update(main_path_q=q, main_path_ms=ms, main_path_bound_ms=b_ms)
    emit({"phase": "main_path_kernel", "name": multi, "q": q, "ms": ms,
          "bound_ms": b_ms, "bound_by": b_by, **extra})
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
        _, counts, seconds2 = run_path(label, master(spec, cfg.q), {multi: calls(family, cfg.q)}, gate(cfg.q),
                                       band, twice=True)
        rows[multi]["launches"] = counts.get(multi, 0)
        return seconds2

    def worker_side(label, family, spec, band=None):
        single = FAMILY_ROUTES[family][0]
        _, counts, _ = run_path(label, worker(spec, SIDE_Q), {single: SIDE_Q}, gate(SIDE_Q), band)
        rows[single]["launches"] = counts.get(single, 0)

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


def phase_new_paths(cfg, rows: dict, key, A, b, gate) -> None:
    """The hybrid, uniform sampling, the two-pass reference and leverage sampling,
    each run twice (bitwise equal), with the S·A and FWHT kernel calls each makes."""
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
    for inner, name in (("gaussian", "gaussian_sketch"), ("rademacher", "rademacher_sketch"), ("srht", "fwht")):
        _, counts = twice(f"worker_hybrid_{inner}", path(worker, hybrid(inner), SIDE_Q), {name: SIDE_Q},
                          SIDE_Q, THEORY_BAND[f"hybrid_{inner}"])
        rows[name].setdefault("launches_by_path", {})[f"worker_hybrid_{inner}"] = counts.get(name, 0)
        rows[name]["launches"] = counts.get(name, 0)

    for family in ("gaussian", "rademacher", "srht", "sjlt"):
        spec = sk.SketchSpec(family, cfg.m, s=SJLT_S, use_kernel=True)
        if family == "srht":
            name, want = "fwht", SIDE_Q
        else:
            name = APPLY_ROUTES[family][1]
            want = -(-SIDE_Q // cuda.worker_chunk(cfg.n, cfg.m, dx, SIDE_Q, family=family, s=SJLT_S))
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

ADJOINT_REPLACES = "src/repro/kernels/gaussian/gram.py:152"
# (m, n, k) of the Gaussian adjoint on the least-norm paths: the Fig. 4(b) Gaussian
# and hybrid-inner sketches, FIG4A's two, and one ragged k > 1 shape.
ADJOINT_SHAPES = ((4000, 11_556, 1), (4000, 8000, 1), (200, 1000, 1), (200, 500, 1), (129, 1001, 3))


def gaussian_library(key, m: int, n: int, device):
    """The adjoint's yardstick: S (m, n) pre-drawn in float32 with the plain tiles,
    then ``run(Y)`` is one ``torch.matmul(S.T, Y)``; the port never calls it."""
    import torch

    from repro_torch.kernels import common
    from repro_torch.kernels.gaussian import ref

    S = ref.sketch_matrix(key, m, n, device=device)

    def run(Y):
        with common.full_fp32_matmul():
            return torch.matmul(S.T, Y)

    return run


def phase_adjoint_kernel(rows: dict) -> None:
    """The Gaussian adjoint kernel against its plain version (float64 product of the
    same float32 S) at each of ADJOINT_SHAPES: per column max_i |Δ|/rms_i ≤ SX_TOL,
    ⟨S·x, y⟩ = ⟨x, Sᵀ·y⟩ with S·x from the S·A kernel, a bitwise rerun, one launch
    a call; card, plain, library ms and the bound."""
    import torch

    from repro_torch.kernels.gaussian import ops, ref
    from repro_torch.utils import prng

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    for m, n, k in ADJOINT_SHAPES:
        key = prng.worker_key(prng.prng_key(SEED + 6), m + n + k)
        Y = torch.randn((m, k), generator=g, device=DEVICE)
        x = torch.randn((n, 1), generator=g, device=DEVICE)
        before = ops.LAUNCHES["gaussian_adjoint"]
        out = ops.gaussian_adjoint(key, Y, n)
        launches = ops.LAUNCHES["gaussian_adjoint"] - before
        rerun = torch.equal(ops.gaussian_adjoint(key, Y, n), out)
        plain, plain_s = host_s(lambda: ref.adjoint(key, Y, n))
        err, abs_err = sx_err(out, plain), float((out - plain).abs().max())
        del plain
        Sx, Sty = ops.gaussian_sketch(key, x, m), ops.gaussian_adjoint(key, Y[:, :1].contiguous(), n)
        lhs, rhs = float(Sx.double().T @ Y[:, :1].double()), float(x.double().T @ Sty.double())
        ident = abs(lhs - rhs) / float(Sx.norm() * Y[:, 0].norm() + x.norm() * Sty.norm())
        library = gaussian_library(key, m, n, Y.device)
        lib_ms, _ = cuda_ms(lambda: library(Y), 10)
        del library
        torch.cuda.empty_cache()
        ms, _ = cuda_ms(lambda: ops.gaussian_adjoint(key, Y, n), 10)
        b_ms, b_by = adjoint_bound_ms(m, n, k)
        report = {"m": m, "n": n, "k": k, "ms": ms, "plain_ms": plain_s * 1e3, "library_ms": lib_ms,
                  "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": abs_err, "max_col_rel_err": err,
                  "tol": SX_TOL, "adjoint_identity_rel_err": ident, "rerun_bitwise": rerun,
                  "launches_per_call": launches}
        emit({"phase": "adjoint_kernel", **report})
        check(err <= SX_TOL, f"gaussian_adjoint at {(m, n, k)} disagrees with its plain version ({err})")
        check(ident <= SX_TOL, f"gaussian_adjoint at {(m, n, k)}: <Sx, y> - <x, S^T y> off by {ident}")
        check(rerun, f"gaussian_adjoint at {(m, n, k)} is not bitwise equal run to run")
        check(launches == 1, f"gaussian_adjoint at {(m, n, k)} counted {launches} launches for one call")
        if "gaussian_adjoint" not in rows:
            rows["gaussian_adjoint"] = {
                "name": "gaussian_adjoint", "route": "cuda", "source": "src/repro_torch/csrc/adjoint.cu",
                "replaces": ADJOINT_REPLACES, "launches": 0, **report, "other_shapes": [],
            }
        else:
            rows["gaussian_adjoint"]["other_shapes"].append(report)


def phase_ln_apply(rows: dict) -> None:
    """The forward kernels at the shapes the least-norm paths give them, on
    Gaussian data: each S·A kernel (rows 6, 7, 12) on X = Aᵀ (d × n) and on the
    hybrid's m′ sampled rows of it, at FIG4A and, for the Gaussian, the Fig. 4(b)
    shape (eight column tiles); the FWHT (row 13) on the SRHT's forward (Aᵀ
    zero-padded to next_pow2(d) and next_pow2(m′) rows) and on the one and 33
    columns its adjoint transforms (m sampled rows scattered into those)."""
    import torch

    from repro_torch.configs.paper_lsq import FIG4A
    from repro_torch.core import sketches as sk
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
# and, for the Gaussian, one adjoint; the SRHT transforms forward and back. A
# hybrid makes its inner kind's calls; sampling makes none.
LN_KERNEL_CALLS = {"gaussian": {"gaussian_sketch": 1, "gaussian_adjoint": 1},
                   "rademacher": {"rademacher_sketch": 1}, "srht": {"fwht": 2}, "sjlt": {"sjlt_apply": 1}}
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
            rows["gaussian_adjoint"]["launches"] = counts.get("gaussian_adjoint", 0)
            phase_trace("least_norm_fig4b_gaussian_traced", solve)
    del A, b, xstar
    torch.cuda.empty_cache()

    A, b, xstar = ln_problem("fig4a", FIG4A.n, FIG4A.d, SEED + 10)
    shape = (A, b, xstar)
    for kind in LN_FIG4_KINDS:
        path(f"least_norm_fig4a_{kind}", kind, *shape, FIG4A.q, FIG4A.m, FIG4A.m_prime)
    q = LN_Q_SIDE
    for kind in LN_SIDE_KINDS:
        x_kernel, *_ = path(f"least_norm_fig4a_{kind}_q{q}", kind, *shape, q, FIG4A.m, FIG4A.m_prime)
        if kind.removeprefix("hybrid_") not in LN_KERNEL_CALLS:
            continue
        x_plain, *_ = path(f"least_norm_fig4a_{kind}_plain", kind, *shape, q, FIG4A.m, FIG4A.m_prime,
                           use_kernel=False)
        rel = float((x_plain - x_kernel).abs().max() / x_kernel.abs().max())
        emit({"phase": "least_norm_plain_vs_kernel", "kind": kind, "q": q, "max_rel_diff": rel,
              "tol": LN_PLAIN_TOL})
        check(rel <= LN_PLAIN_TOL, f"least-norm {kind}: x̄ without kernels {rel} off the kernel path's x̄")


def phase_trace(label: str, solve) -> None:
    """One more run of a path under ``torch.profiler``: device time by kernel and the
    device's busy share of the run's wall time (kernels on one stream, so their
    times add). The untraced runs give the end-to-end numbers."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0][:80]
            by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    emit({"phase": label, "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / (wall * 1e3), "device_kernels": len(by_kernel),
          "top_kernels_ms": top})


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
        A, b, _ = regression.gaussian_regression(SEED + 2, FIG3A.n, FIG3A.d, device=DEVICE)
        rows: dict = {}
        X = torch.cat([A, b[:, None]], dim=1)
        del A, b
        phase_kernels(X, FIG3A.m, rows)
        phase_apply_kernels(X, FIG3A.m, FIG3A.m_prime, rows)
        phase_fwht(X, FIG3A.m_prime, rows)
        del X
        torch.cuda.empty_cache()
        phase_main_path(FIG3A, rows)
        phase_adjoint_kernel(rows)
        phase_ln_apply(rows)
        phase_least_norm(rows)
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
