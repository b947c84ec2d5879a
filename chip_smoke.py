#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source,
in parallel), checks the device counter RNG against the plain PyTorch contract,
holds each sketch→Gram kernel (Gaussian, Rademacher, SRHT, SJLT with FIG3A's
s = 20) against its plain version at the FIG3A shape (n = 500,000, d = 250,
m = 2,500), q = 1 and 2, then runs Algorithm 1 end to end:

* Gaussian: master-sketch mode at q = 200 (twice, bitwise equal; once more
  traced), worker-side mode at q = 8;
* Rademacher: both modes at q = 8;
* SRHT and SJLT: master-sketch mode at q = 200 (twice, bitwise equal; the SJLT
  once more traced), worker-side mode at q = 8; the SRHT's host-side row draw
  is timed alone.

Each path runs with the launch counts at 0 and must make exactly the calls into
the kernels' C entries that its worker chunks call for. The multi-key Grams of
the main path are held, at the edges of their worker chunks, against
single-key calls (bitwise) and the plain version (per entry). Each phase prints
one JSON line; any failed check exits non-zero. The second-to-last line is the
kernels summary; the last line is ``{"ok": true, "device": {...}}``.

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
# cuts of FIG3A on the same planted data, the SRHT and the SJLT (s = 20) gave
# rel_err / Theorem 1 of 0.70-1.35 and 0.67-1.35 (d = 25, 4 seeds) and 0.75-1.12
# and 0.73-1.10 (d = 100, 6 seeds), the Gaussian 0.72-1.35 and 0.79-1.23
# (tests/theory_ratio.py; PERF.md §6); at d = 250 the spread is ~9%. Their gate is the band [1/2, 2].
THEORY_BAND = {"srht": (0.5, 2.0), "sjlt": (0.5, 2.0)}
CHECK_Q = 2  # workers in the kernel-against-plain phase
SIDE_Q = 8  # workers in the worker-side and Rademacher phases
SJLT_S = 20  # FIG3A's nonzeros per data row (RegressionConfig.s)

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): 67 TFLOP/s float32 outside the
# tensor cores, 3.35 TB/s HBM. INT32: 64 lanes per SM (half the 128 FP32 lanes,
# Hopper white paper) at the same clock, so 67/4 = 16.7 T integer ops/s.
PEAK_FP32_FLOPS = 67e12
PEAK_INT32_OPS = 16.7e12
PEAK_BYTES = 3.35e12


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
             s: int = SJLT_S) -> tuple[float, str]:
    """Least time the card could take for q fused Grams of X (n, dx): the larger of
    the bytes (X read once, G written once) over HBM rate and each operation type
    over its peak: fp32 FFMA for S·X and the Gram; int32 for drawing S.

    Dense families do 2·m·n·dx FFMA flops per worker. Integer work per S entry:
    Gaussian one threefry; Rademacher 1/32 of one; SRHT an AND, a popcount and a
    select (3) plus one threefry per data row for the diagonal. The SJLT does
    2·n·s·dx flops (s nonzeros per data row) and one threefry, a remainder and a
    sign per (row, t) pair."""
    bytes_ms = 4 * (n * dx + q * dx * dx) / PEAK_BYTES * 1e3
    gram_flops = 2 * m * dx * dx * q
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


def dense_library(calls: Calls, X, q: int):
    """The yardstick of a dense family: each worker's S (m, n) materialized in
    float32 with the plain tiles, then one ``torch.matmul`` for S·X and one for
    the Gram. Returns ``run(k)``, which does that for the first k <= q workers;
    the port never calls it."""
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
            return [sx.T @ sx for sx in (s @ X for s in S[:k])]

    return run


def sjlt_library(calls: Calls, X, q: int):
    """The SJLT's yardstick: per worker one ``index_add_`` of the pre-built signed,
    replicated rows (n·s, d) into (m, d) (atomics, so not deterministic), then one
    ``torch.matmul`` for the Gram. The parameters and the (n·s, d) source are made
    before any timing. Returns ``run(k)`` for the first k <= q workers; the port
    never calls it."""
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
                out.append(acc.T @ acc)
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


def reset_counts() -> None:
    for family in FAMILY_ROUTES:
        family_modules(family)[0].LAUNCHES.clear()


def read_counts() -> dict:
    out = {}
    for family in FAMILY_ROUTES:
        out.update(family_modules(family)[0].LAUNCHES)
    return out


def run_path(label: str, solve, expect: dict, A64, b64, fstar, m: int, q: int, band=None):
    """Drive one path with the counts at 0; check its kernels ran and its error:
    rel_err / Theorem 1 within ``band`` (default [1/THEORY_FACTOR, THEORY_FACTOR])."""
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
        phase_kernels(torch.cat([A, b[:, None]], dim=1), FIG3A.m, rows)
        del A, b
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
