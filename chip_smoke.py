#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source,
in parallel), checks the device counter RNG against the plain PyTorch contract,
holds each sketch→Gram kernel against its plain version at the FIG3A shape
(n = 500,000, d = 250, m = 2,500), then runs Algorithm 1 end to end: master-sketch
mode with the Gaussian family at q = 200 (twice, bitwise equal), and worker-side
mode plus the Rademacher family at q = 8. Each path runs with the launch counts
at 0 and must make exactly the calls into the kernels' C entries that its worker
chunks call for. The multi-key Grams of the main path (q = 200 and q = 8) are
held, at the edges of their worker chunks, against single-key calls (bitwise)
and the plain version (per entry). Each phase prints one JSON line; any
failed check exits non-zero. The second-to-last line is the kernels summary; the
last line is ``{"ok": true, "device": {...}}``.

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
CHECK_Q = 2  # workers in the kernel-against-plain phase
SIDE_Q = 8  # workers in the worker-side and Rademacher phases

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


def bound_ms(family: str, n: int, dx: int, m: int, q: int, rounds: int) -> tuple[float, str]:
    """Least time the card could take for q fused Grams of X (n, dx): the larger of
    the bytes (X read once, G written once) over HBM rate and each operation type
    over its peak (fp32 FFMA for S·X and the Gram; int32 threefry for S)."""
    bytes_ms = 4 * (n * dx + q * dx * dx) / PEAK_BYTES * 1e3
    flops = 2 * m * n * dx * q + 2 * m * dx * dx * q
    fp_ms = flops / PEAK_FP32_FLOPS * 1e3
    per_entry = threefry_ops(rounds) if family == "gaussian" else threefry_ops(20) / 32
    int_ms = m * n * q * per_entry / PEAK_INT32_OPS * 1e3
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
}


def family_modules(family: str):
    if family == "gaussian":
        from repro_torch.kernels.gaussian import ops, ref
    else:
        from repro_torch.kernels.rademacher import ops, ref
    return ops, ref


def predrawn_sketches(ref, keys, m: int, n: int, device):
    """Each worker's S (m, n) materialized in float32 with the plain tiles: the
    input of the library yardstick, never used by the port."""
    import torch

    from repro_torch.kernels import common

    out = []
    for key in keys:
        k0, k1 = common.key_words(key)
        S = torch.empty((m, n), dtype=torch.float32, device=device)
        for j0 in range(0, n, ref.PLAIN_BLOCK_ROWS):
            blk = min(ref.PLAIN_BLOCK_ROWS, n - j0)
            S[:, j0 : j0 + blk] = ref.columns(k0, k1, m, j0, blk, device)
        out.append(S)
    return out


def phase_kernels(X, m: int, rows: dict) -> None:
    """Each kernel against its plain version at the main path's (n, d', m), q = 2."""
    import torch

    from repro_torch.kernels import common
    from repro_torch.utils import prng

    n, dx = X.shape
    keys = prng.worker_keys(prng.prng_key(SEED + 1), CHECK_Q)
    for family, (single, multi, src_single, src_multi) in FAMILY_ROUTES.items():
        ops, ref = family_modules(family)
        fn_single = getattr(ops, single)
        fn_multi = getattr(ops, multi)
        rounds = common.rng_rounds() if family == "gaussian" else common.DEFAULT_ROUNDS
        G_multi = fn_multi(keys, X, m)
        G_single = [fn_single(k, X, m) for k in keys]
        bitwise = all(torch.equal(G_multi[w], G_single[w]) for w in range(CHECK_Q))
        rerun = torch.equal(fn_multi(keys, X, m), G_multi)
        G_plain, plain_s = host_s(lambda: getattr(ref, multi)(keys, X, m))
        abs_multi = float((G_multi - G_plain).abs().max())
        abs_single = float((G_single[0] - G_plain[0]).abs().max())
        err_multi, err_single = gram_err(G_multi, G_plain), gram_err(G_single[0], G_plain[0])
        _, plain_single_s = host_s(lambda: getattr(ref, single)(keys[0], X, m))
        S = predrawn_sketches(ref, keys, m, n, X.device)

        def library(q):
            with common.full_fp32_matmul():
                return [sx.T @ sx for sx in (s @ X for s in S[:q])]

        lib_single, _ = cuda_ms(lambda: library(1), 3)
        lib_multi, _ = cuda_ms(lambda: library(CHECK_Q), 3)
        del S
        ms_single, _ = cuda_ms(lambda: fn_single(keys[0], X, m), 3)
        ms_multi, _ = cuda_ms(lambda: fn_multi(keys, X, m), 3)
        for name, src, q, ms, plain_ms, lib_ms, abs_err, err in (
            (single, src_single, 1, ms_single, plain_single_s * 1e3, lib_single, abs_single, err_single),
            (multi, src_multi, CHECK_Q, ms_multi, plain_s * 1e3, lib_multi, abs_multi, err_multi),
        ):
            b_ms, b_by = bound_ms(family, n, dx, m, q, rounds)
            rows[name] = {
                "name": name, "route": "cuda", "source": "src/repro_torch/csrc/sketch_gram.cu",
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


def run_path(label: str, solve, expect: dict, A64, b64, fstar, m: int, q: int):
    """Drive one path with the counts at 0; check its kernels ran and its error."""
    import torch

    from repro_torch.core import solve as solve_mod, theory

    reset_counts()
    xbar, seconds = host_s(solve)
    counts = read_counts()
    d = A64.shape[1]
    rel = float(solve_mod.relative_error(A64, b64, xbar.double(), fstar))
    pred = theory.gaussian_averaged_error(m, d, q)
    emit({"phase": label, "q": q, "seconds": seconds, "rel_err": rel, "theory": pred,
          "ratio": rel / pred, "launches": counts})
    check(tuple(xbar.shape) == (d,) and bool(torch.isfinite(xbar).all()), f"{label}: bad x̄")
    for name, want in expect.items():
        check(counts.get(name, 0) == want, f"{label}: {name} launched {counts.get(name, 0)}×, want {want}")
    check(pred / THEORY_FACTOR <= rel <= THEORY_FACTOR * pred,
          f"{label}: rel_err {rel} outside {THEORY_FACTOR}× of Theorem 1's {pred}")
    return xbar, counts


def check_main_path_slices(family: str, keys, X, m: int, G) -> None:
    """Slices of a main-path multi-key Gram at the edges of its worker chunks:
    bitwise equal to single-key calls, and the last held against the plain version."""
    import torch

    from repro_torch.kernels import cuda

    single, multi, *_ = FAMILY_ROUTES[family]
    ops, ref = family_modules(family)
    n, dx = X.shape
    q = keys.shape[0]
    chunk = cuda.worker_chunk(n, m, dx, q)
    ws = sorted({0, chunk - 1, chunk, q - 1} & set(range(q)))
    bitwise = {str(w): torch.equal(G[w], getattr(ops, single)(keys[w], X, m)) for w in ws}
    err = gram_err(G[q - 1], getattr(ref, single)(keys[q - 1], X, m))
    emit({"phase": "main_path_slices", "name": multi, "q": q, "workers_per_call": chunk,
          "slices_bitwise_equal_single": bitwise, "last_slice_entry_rel_err": err,
          "tol": GRAM_TOL})
    check(all(bitwise.values()), f"{multi} at q = {q}: slices {bitwise} not all bitwise equal to {single}")
    check(err <= GRAM_TOL, f"{multi} at q = {q}: slice {q - 1} off its plain version by {err}")


def phase_main_path(cfg, rows: dict):
    import torch

    from repro_torch.core import distributed, sketches as sk, solve
    from repro_torch.data import regression
    from repro_torch.kernels import common, cuda
    from repro_torch.kernels.gaussian import ops as gops
    from repro_torch.kernels.rademacher import ops as rops
    from repro_torch.utils import prng

    A, b, _ = regression.gaussian_regression(SEED, cfg.n, cfg.d, device="cuda")
    A64, b64 = A.double(), b.double()
    (xstar, fstar), xs_s = host_s(lambda: _exact(solve, A64, b64))
    emit({"phase": "exact_solve", "seconds": xs_s, "fstar": float(fstar)})
    key = prng.prng_key(SEED)
    dx = cfg.d + 1

    def calls(q: int) -> int:
        return -(-q // cuda.worker_chunk(cfg.n, cfg.m, dx, q))

    gauss = sk.SketchSpec("gaussian", cfg.m, use_kernel=True)
    master = lambda: distributed.distributed_sketch_solve_master(gauss, key, A, b, q=cfg.q)
    x1, counts = run_path("master_gaussian", master, {"gaussian_gram_multi": calls(cfg.q)},
                          A64, b64, fstar, cfg.m, cfg.q)
    rows["gaussian_gram_multi"]["launches"] = counts["gaussian_gram_multi"]
    x2, seconds2 = host_s(master)
    same = torch.equal(x1, x2)
    emit({"phase": "master_gaussian_rerun", "seconds": seconds2, "bitwise_equal": same})
    check(same, "master-mode x̄ is not bitwise equal run to run")
    phase_trace("master_gaussian_traced", master)

    # The master path's own kernel call, timed alone and then checked.
    X = torch.cat([A, b[:, None]], dim=1)
    keys = prng.worker_keys(key, cfg.q)
    ms, G = cuda_ms(lambda: gops.gaussian_gram_multi(keys, X, cfg.m), 1, warmup=False)
    b_ms, b_by = bound_ms("gaussian", cfg.n, dx, cfg.m, cfg.q, common.rng_rounds())
    rows["gaussian_gram_multi"].update(main_path_q=cfg.q, main_path_ms=ms, main_path_bound_ms=b_ms)
    emit({"phase": "main_path_kernel", "name": "gaussian_gram_multi", "q": cfg.q, "ms": ms,
          "bound_ms": b_ms, "bound_by": b_by, "solve_seconds": seconds2})
    check_main_path_slices("gaussian", keys, X, cfg.m, G)
    del G

    rad = sk.SketchSpec("rademacher", cfg.m, use_kernel=True)
    for label, fn, expect in (
        ("worker_gaussian", distributed.distributed_sketch_solve, {"gaussian_gram": SIDE_Q}),
        ("master_rademacher", distributed.distributed_sketch_solve_master,
         {"rademacher_gram_multi": calls(SIDE_Q)}),
        ("worker_rademacher", distributed.distributed_sketch_solve, {"rademacher_gram": SIDE_Q}),
    ):
        spec = gauss if label.endswith("gaussian") else rad
        _, counts = run_path(label, lambda: fn(spec, key, A, b, q=SIDE_Q), expect,
                             A64, b64, fstar, cfg.m, SIDE_Q)
        for name in expect:
            rows[name]["launches"] = counts[name]

    keys = prng.worker_keys(key, SIDE_Q)
    ms, G = cuda_ms(lambda: rops.rademacher_gram_multi(keys, X, cfg.m), 1, warmup=False)
    b_ms, b_by = bound_ms("rademacher", cfg.n, dx, cfg.m, SIDE_Q, common.DEFAULT_ROUNDS)
    rows["rademacher_gram_multi"].update(main_path_q=SIDE_Q, main_path_ms=ms, main_path_bound_ms=b_ms)
    emit({"phase": "main_path_kernel", "name": "rademacher_gram_multi", "q": SIDE_Q, "ms": ms,
          "bound_ms": b_ms, "bound_by": b_by})
    check_main_path_slices("rademacher", keys, X, cfg.m, G)


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
