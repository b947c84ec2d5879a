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
from pathlib import Path

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
            ny = Y.shape[0]
            SX = calls.single(0, Y)
            rerun = torch.equal(calls.single(0, Y), SX)
            plain, plain_s = host_s(lambda: calls.plain_single(0, Y))
            err, abs_err = sx_err(SX, plain), float((SX - plain).abs().max())
            library = make_library(Calls(family, keys, ny, m), Y, 1, gram=False)
            lib_ms, _ = cuda_ms(lambda: library(1), 3)
            del library, plain
            torch.cuda.empty_cache()
            ms, _ = cuda_ms(lambda: calls.single(0, Y), 3)
            b_ms, b_by = bound_ms(family, ny, dx, m, 1, rounds, apply=True)
            report[label] = {"n": ny, "ms": ms, "plain_ms": plain_s * 1e3, "library_ms": lib_ms,
                             "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": abs_err,
                             "max_col_rel_err": err, "rerun_bitwise": rerun}
            check(err <= SX_TOL, f"{single} on {ny} rows disagrees with its plain version ({err})")
            check(rerun, f"{single} on {ny} rows is not bitwise equal run to run")
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
    from repro_torch.kernels import cuda
    from repro_torch.kernels.fwht import ops, ref

    n, dx = X.shape
    report = {"phase": "fwht", "d": dx}
    for rows_in in (n, m_prime):
        n_pad = sk.next_pow2(rows_in)
        x = torch.zeros((n_pad, dx), dtype=torch.float32, device=X.device)
        x[:rows_in] = X[:rows_in]
        y = ops.fwht(x)
        plain, plain_s = host_s(lambda: ref.fwht(x))
        bitwise = torch.equal(y, plain)
        abs_err = float((y - plain).abs().max())
        del plain
        rerun = torch.equal(ops.fwht(x), y)
        ms, _ = cuda_ms(lambda: ops.fwht(x), 5)
        b_ms, b_by = fwht_bound_ms(n_pad, dx)
        report[str(n_pad)] = {"passes": list(cuda.plan_fwht(n_pad)), "ms": ms, "plain_ms": plain_s * 1e3,
                              "bound_ms": b_ms, "bound_by": b_by, "bitwise_equal_plain": bitwise,
                              "max_abs_err": abs_err, "rerun_bitwise": rerun}
        check(bitwise, f"fwht on {n_pad} rows is not bitwise equal to its plain version")
        check(rerun, f"fwht on {n_pad} rows is not bitwise equal run to run")
        if "fwht" not in rows:
            rows["fwht"] = {
                "name": "fwht", "route": "cuda", "source": "src/repro_torch/csrc/fwht.cu",
                "replaces": FWHT_REPLACES, "launches": 0, "max_abs_err": abs_err, "ms": ms,
                "plain_ms": plain_s * 1e3, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "shape": {"n_pad": n_pad, "d": dx},
            }
        else:
            rows["fwht"]["hybrid_shape"] = {"n_pad": n_pad, "ms": ms, "plain_ms": plain_s * 1e3,
                                            "bound_ms": b_ms}
    emit(report)


def reset_counts() -> None:
    for family in FAMILY_ROUTES:
        family_modules(family)[0].LAUNCHES.clear()


def read_counts() -> dict:
    out = {}
    for family in FAMILY_ROUTES:
        out.update(family_modules(family)[0].LAUNCHES)
    return out


def run_path(label: str, solve, expect: dict, A64, b64, fstar, m: int, q: int, band=None):
    """Drive one path with the counts at 0; check that it made exactly the kernel
    calls of ``expect`` and no others, and its error: rel_err / Theorem 1 within
    ``band`` (default [1/THEORY_FACTOR, THEORY_FACTOR])."""
    import torch

    from repro_torch.core import solve as solve_mod, theory

    reset_counts()
    xbar, seconds = host_s(solve)
    counts = read_counts()
    d = A64.shape[1]
    rel = float(solve_mod.relative_error(A64, b64, xbar.double(), fstar))
    pred = theory.gaussian_averaged_error(m, d, q)
    lo, hi = band or (1 / THEORY_FACTOR, THEORY_FACTOR)
    emit({"phase": label, "q": q, "seconds": seconds, "rel_err": rel, "theory": pred,
          "ratio": rel / pred, "ratio_band": [lo, hi], "launches": counts})
    check(tuple(xbar.shape) == (d,) and bool(torch.isfinite(xbar).all()), f"{label}: bad x̄")
    for name, want in expect.items():
        check(counts.get(name, 0) == want, f"{label}: {name} launched {counts.get(name, 0)}×, want {want}")
    stray = {name: c for name, c in counts.items() if c and name not in expect}
    check(not stray, f"{label}: launched kernels it should not: {stray}")
    check(lo * pred <= rel <= hi * pred,
          f"{label}: rel_err {rel} outside [{lo}, {hi}]× Theorem 1's {pred}")
    return xbar, counts


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

    A, b, _ = regression.gaussian_regression(SEED, cfg.n, cfg.d, device="cuda")
    A64, b64 = A.double(), b.double()
    (xstar, fstar), xs_s = host_s(lambda: _exact(solve, A64, b64))
    emit({"phase": "exact_solve", "seconds": xs_s, "fstar": float(fstar)})
    key = prng.prng_key(SEED)
    dx = cfg.d + 1
    X = torch.cat([A, b[:, None]], dim=1)

    def calls(family: str, q: int) -> int:
        return -(-q // cuda.worker_chunk(cfg.n, cfg.m, dx, q, family=family, s=SJLT_S))

    def master(spec, q):
        return lambda: distributed.distributed_sketch_solve_master(spec, key, A, b, q=q)

    def worker(spec, q):
        return lambda: distributed.distributed_sketch_solve(spec, key, A, b, q=q)

    def master_twice(label, family, spec, band=None):
        multi = FAMILY_ROUTES[family][1]
        x1, counts = run_path(label, master(spec, cfg.q), {multi: calls(family, cfg.q)},
                              A64, b64, fstar, cfg.m, cfg.q, band)
        rows[multi]["launches"] = counts.get(multi, 0)
        x2, seconds2 = host_s(master(spec, cfg.q))
        same = torch.equal(x1, x2)
        emit({"phase": f"{label}_rerun", "seconds": seconds2, "bitwise_equal": same})
        check(same, f"{label}: master-mode x̄ is not bitwise equal run to run")
        return seconds2

    def worker_side(label, family, spec, band=None):
        single = FAMILY_ROUTES[family][0]
        _, counts = run_path(label, worker(spec, SIDE_Q), {single: SIDE_Q},
                             A64, b64, fstar, cfg.m, SIDE_Q, band)
        rows[single]["launches"] = counts.get(single, 0)

    gauss = sk.SketchSpec("gaussian", cfg.m, use_kernel=True)
    seconds2 = master_twice("master_gaussian", "gaussian", gauss)
    phase_trace("master_gaussian_traced", master(gauss, cfg.q))
    keys = prng.worker_keys(key, cfg.q)
    main_path_kernel("gaussian", keys, X, cfg.m, rows, solve_seconds=seconds2)

    rad = sk.SketchSpec("rademacher", cfg.m, use_kernel=True)
    worker_side("worker_gaussian", "gaussian", gauss)
    _, counts = run_path("master_rademacher", master(rad, SIDE_Q),
                         {"rademacher_gram_multi": calls("rademacher", SIDE_Q)},
                         A64, b64, fstar, cfg.m, SIDE_Q)
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
    phase_new_paths(cfg, rows, key, A, b, A64, b64, fstar)


def phase_new_paths(cfg, rows: dict, key, A, b, A64, b64, fstar) -> None:
    """The hybrid, uniform sampling, the two-pass reference and leverage sampling,
    each run twice (bitwise equal), with the S·A and FWHT kernel calls each makes."""
    import torch

    from repro_torch.core import distributed, operators, sketches as sk
    from repro_torch.kernels import cuda
    from repro_torch.utils import prng

    dx = cfg.d + 1
    master, worker = distributed.distributed_sketch_solve_master, distributed.distributed_sketch_solve

    def path(entry, spec, q, method="fused"):
        return lambda: entry(spec, key, A, b, q=q, method=method)

    def twice(label, solve, expect, q, band):
        x1, counts = run_path(label, solve, expect, A64, b64, fstar, cfg.m, q, band)
        x2, seconds2 = host_s(solve)
        same = torch.equal(x1, x2)
        emit({"phase": f"{label}_rerun", "seconds": seconds2, "bitwise_equal": same})
        check(same, f"{label}: x̄ is not bitwise equal run to run")
        return x1, counts

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
        A, b, _ = regression.gaussian_regression(SEED + 2, FIG3A.n, FIG3A.d, device="cuda")
        rows: dict = {}
        X = torch.cat([A, b[:, None]], dim=1)
        del A, b
        phase_kernels(X, FIG3A.m, rows)
        phase_apply_kernels(X, FIG3A.m, FIG3A.m_prime, rows)
        phase_fwht(X, FIG3A.m_prime, rows)
        del X
        torch.cuda.empty_cache()
        phase_main_path(FIG3A, rows)
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
