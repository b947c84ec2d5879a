#!/usr/bin/env python3
"""Time the dense sketch→Gram kernel (``src/repro_torch/csrc/sketch_gram.cu``)
with parts of its work left out, to see what holds it back at one shape.

Run from the root of a checkout, on a machine with one CUDA card and ``nvcc``:

    python3 tools/gram_ablation.py [--family gaussian] [--shape N,D,M] [--q 1] [--reps 5]
                                   [--variants full,no_x,...] [--extra NAME=FILE.cu ...]
                                   [--parent FILE.cu] [--max-cluster N] [--out PATH]

``--family`` (``gaussian``, the default, ``rademacher`` or ``srht``) picks the
family of the one tensor-core pass (``repro_dense_gram``): a split pass writes X
once as TF32 hi and lo parts; producer warps draw S (the Gaussian's S tile, or
the ±1 families' sign words), consumer warps copy the X tiles (bulk copies
multicast over a cluster of m-tiles) and multiply on the tensor cores (three
products a k-slice, or two); mbarrier rings hand the steps over. The shape
defaults to FIG3A's full n.

The source's ``SKETCH_GRAM_ABLATE`` bits leave out the draw (1), the X copy (2),
the split pass (4) or the products (8), and every build below sets some of them
(``VARIANTS``); ``chains_2``, ``chains_4``, ``chains_16`` and ``long_chains``
instead build chains of 2, 4 or 16 steps, or one chain a split, before the running sums (the
second level of the two-level sum), and their error is printed. Every variant
keeps the hand-offs, so ``handoffs_only`` is the cost of the pipeline itself.
``--extra`` adds a patched copy of the source, built whole, as one more variant
(held bitwise against the port's build). Beside the variants more calls are
timed on the same keys and X: for the Gaussian and the Rademacher
``sketch_apply``, the dense S·A kernel (``csrc/sketch_apply.cu``: S·X alone, no
Gram), and with ``--parent`` the ``sketch_gram.cu`` of the commit before the ±1
families moved onto the tensor cores (``git archive 9ca1d14``), timed whole: its
Gaussian tensor-core pass (``repro_gaussian_gram``, on the same plan) or its
FFMA pass for the ±1 families (``repro_sketch_gram``, on the split plan it had).
Each call is timed with CUDA events, the variants interleaved (their order
rotated each repetition), one call a repetition (``--reps`` of them, the median
kept, every run printed). ``entry_err`` is max |ΔG_ij|/√(G_ii·G_jj) against the
plain version. ``mma_floor_ms`` is the pass's TF32 products at ``mma.sync``'s own
rate, measured in the same run (``csrc/mma_probe.cu``); ``rng_bound_ms`` the draw
at 16.7 T integer operations a second.

Prints one JSON line (also appended to ``--out``) and, first, the card's name
and power limit. Ablated variants compute wrong results by design; nothing here is
on a solve path.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

VARIANTS = {
    "full": "-DSKETCH_GRAM_ABLATE=0",
    "no_draw": "-DSKETCH_GRAM_ABLATE=1",
    "no_x": "-DSKETCH_GRAM_ABLATE=2",
    "no_split": "-DSKETCH_GRAM_ABLATE=4",
    "no_mma": "-DSKETCH_GRAM_ABLATE=8",
    "draw_only": "-DSKETCH_GRAM_ABLATE=14",  # draw, hand-offs
    "x_only": "-DSKETCH_GRAM_ABLATE=9",  # split pass, X copy, hand-offs
    "mma_only": "-DSKETCH_GRAM_ABLATE=7",  # products, hand-offs
    "handoffs_only": "-DSKETCH_GRAM_ABLATE=15",
    "chains_2": "-DSKETCH_GRAM_CHAIN_STEPS=2",
    "chains_4": "-DSKETCH_GRAM_CHAIN_STEPS=4",
    "chains_16": "-DSKETCH_GRAM_CHAIN_STEPS=16",
    "long_chains": "-DSKETCH_GRAM_CHAIN_STEPS=1048576",
}
CHAINS = ("chains_2", "chains_4", "chains_16", "long_chains")
PASSES = {"gaussian": 3, "rademacher": 2, "srht": 2}  # TF32 products a k-slice
FIG3A = (500_000, 251, 2_500)  # n, d' = d + 1, m
THREEFRY_OPS = 77  # one threefry2x32 at 20 rounds
PEAK_INT32_OPS = 16.7e12


def build(variants: list[str], extra: dict[str, Path], parent: Path | None) -> tuple[dict[str, ctypes.CDLL], dict]:
    """One library per variant, all ``nvcc`` at once, into the build directory;
    and each variant's kernels' registers and spills (ptxas)."""
    from repro_torch.kernels import cuda

    nvcc = cuda.nvcc_path()
    out_dir = cuda.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {name: (cuda.CSRC / "sketch_gram.cu", VARIANTS[name].split()) for name in variants}
    jobs.update({name: (path, []) for name, path in extra.items()})
    if parent is not None:
        jobs["parent"] = (parent, [])
    procs = {}
    for name, (src, defs) in jobs.items():
        so = out_dir / f"libsketch_gram-{name}-{os.getpid()}.so"
        cmd = [nvcc, *cuda.NVCC_FLAGS, *defs, "-I", str(src.parent), "-I", str(cuda.CSRC), "-o", str(so), str(src)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, usage = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        if name == "parent":  # the entries as they were before the ±1 families moved
            P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
            lib.repro_sketch_gram.argtypes = [I, P, LL, I, P, P, I, I, F, LL, I, P, P, P]
            lib.repro_sketch_gram.restype = I
            lib.repro_gaussian_gram.argtypes = [P, LL, I, P, I, I, F, I, LL, I, I, I, I, P, LL, I, P, P, P]
            lib.repro_gaussian_gram.restype = I
            lib.repro_error_string.argtypes = [I]
            lib.repro_error_string.restype = ctypes.c_char_p
        else:
            cuda._declare("sketch_gram", lib)
        libs[name] = lib
        usage[name] = {r["kernel"]: f"{r.get('registers')} regs, "
                                    f"spills {r.get('spill_stores')}/{r.get('spill_loads')} B"
                       for r in cuda.ptxas_usage(log) if "partial_kernel" in r["kernel"]}
    return libs, usage


def parent_gram(lib, family: str, keys, X, m: int, srht_rows):
    """The parent's Grams (q, d, d), all q workers in one call: its Gaussian
    tensor-core pass (``repro_gaussian_gram``, on ``cuda.plan_dense_gram``, the
    plan it had), or its FFMA pass for the ±1 families (``repro_sketch_gram``, on
    its FFMA split plan: blocks of 64 sketch rows by 256 columns)."""
    import torch

    from repro_torch.kernels import common, cuda

    n, d = X.shape
    q = keys.shape[0]
    kw = cuda._u32_words(keys, X.device)
    G = torch.empty((q, d, d), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream().cuda_stream
    if family == "gaussian":
        plan = cuda.plan_dense_gram(n, m, d)
        xs = torch.empty(plan.xs_floats, dtype=torch.float32, device=X.device)
        partial = torch.empty((q, plan.n_splits * m * d), dtype=torch.float32, device=X.device)
        code = lib.repro_gaussian_gram(X.data_ptr(), n, d, kw.data_ptr(), q, m, common.inv_sqrt(m),
                                       common.rng_rounds(), plan.rows_per_split, plan.n_splits, plan.block_cols,
                                       plan.cluster, plan.clusters, xs.data_ptr(), plan.x_rows, 1,
                                       partial.data_ptr(), G.data_ptr(), stream)
    else:
        n_splits, rows = cuda._split_rows(n, -(-m // 64) * -(-d // 256))
        partial = torch.empty((q, n_splits * m * d), dtype=torch.float32, device=X.device)
        rw = None if srht_rows is None else cuda._u32_words(srht_rows, X.device)
        code = lib.repro_sketch_gram(cuda.FAMILIES[family], X.data_ptr(), n, d, kw.data_ptr(),
                                     None if rw is None else rw.data_ptr(), q, m, common.inv_sqrt(m), rows,
                                     n_splits, partial.data_ptr(), G.data_ptr(), stream)
    cuda._check(lib, code, "parent sketch_gram launch")
    return G


def plain_grams(family: str, keys, X, m: int, srht_rows) -> list:
    """Each worker's Gram by the family's plain version (float64 S tiles)."""
    from repro_torch.kernels.fwht import ref as fref
    from repro_torch.kernels.gaussian import ref as gref
    from repro_torch.kernels.rademacher import ref as rref

    if family == "gaussian":
        return [gref.gaussian_gram(keys[w], X, m) for w in range(keys.shape[0])]
    if family == "rademacher":
        return [rref.rademacher_gram(keys[w], X, m) for w in range(keys.shape[0])]
    return [fref.srht_gram(keys[w], srht_rows[w], X) for w in range(keys.shape[0])]


def time_calls(calls: dict, reps: int) -> dict[str, list[float]]:
    """Per-call runs in ms: one warm-up each, then ``reps`` rounds, the calls'
    order rotated each round."""
    import torch

    names = list(calls)
    runs = {name: [] for name in names}
    for name in names:
        calls[name]()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for r in range(reps):
        for name in names[r % len(names):] + names[:r % len(names)]:
            torch.cuda.synchronize()
            start.record()
            calls[name]()
            stop.record()
            torch.cuda.synchronize()
            runs[name].append(start.elapsed_time(stop))
    return runs


def entry_err(G, want) -> float:
    """max |ΔG_ij| / sqrt(want_ii·want_jj)."""
    G, want = G.double(), want.double()
    diag = want.diagonal().clamp_min(0)
    return float(((G - want).abs() / (diag[:, None] * diag[None, :]).sqrt()).max())


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--family", default="gaussian", choices=["gaussian", "rademacher", "srht"])
    parser.add_argument("--shape", default=",".join(map(str, FIG3A)), help="n,d,m (default FIG3A's full n)")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--q", type=int, default=1)
    parser.add_argument("--seed", type=int, default=20260)
    parser.add_argument("--max-cluster", type=int, default=None,
                        help="plan the tensor-core pass with clusters of at most this many m-tiles")
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "gram_ablation.jsonl")
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help=f"comma-separated subset of {', '.join(VARIANTS)} (always with full)")
    parser.add_argument("--extra", action="append", default=[], metavar="NAME=FILE.cu",
                        help="a patched copy of sketch_gram.cu, built whole, as one more variant")
    parser.add_argument("--parent", type=Path, default=None, metavar="FILE.cu",
                        help="the sketch_gram.cu of 9ca1d14 (before the ±1 families moved), timed whole")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gram_ablation: CUDA is not available", file=sys.stderr)
        return 2
    gaussian = args.family == "gaussian"
    torch.backends.cuda.matmul.allow_tf32 = False
    extra = {}
    for item in args.extra:
        name, _, path = item.partition("=")
        extra[name] = Path(path).resolve()
    variants = ["full"] + [v for v in args.variants.split(",") if v and v != "full"]
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        parser.error(f"unknown variants {sorted(unknown)}")
    from apply_ablation import mma_tflops

    from repro_torch.kernels import common, cuda
    from repro_torch.utils import prng

    if args.max_cluster:
        cuda.GRAM_MAX_CLUSTER = args.max_cluster
        cuda.plan_dense_gram.cache_clear()
    t0 = time.perf_counter()
    cuda.build(["sketch_gram", "sketch_apply", "mma_probe"])
    libs, usage = build(variants, extra, args.parent.resolve() if args.parent else None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    rate = mma_tflops()
    head = {"card": smi, "build_s": time.perf_counter() - t0, "mma_sync_tf32_tflops": rate,
            "variants": {**{v: VARIANTS[v] for v in variants}, **{k: "extra" for k in extra}}, "ptxas": usage}
    print(json.dumps(head), flush=True)

    n, d, m = (int(v) for v in args.shape.split(","))
    rs = np.random.default_rng(args.seed)
    X = torch.from_numpy(rs.standard_normal((n, d)).astype(np.float32)).cuda()
    keys = prng.worker_keys(prng.prng_key(args.seed), args.q)
    rows = (torch.from_numpy(rs.integers(0, 2**31, size=(args.q, m))) if args.family == "srht" else None)
    rounds = common.rng_rounds() if gaussian else common.DEFAULT_ROUNDS
    counter: collections.Counter = collections.Counter()
    own = cuda._LIBS.get("sketch_gram")

    def port_call(lib):
        def call():
            cuda._LIBS["sketch_gram"] = lib
            return cuda.sketch_gram(args.family, keys, X, m, rounds=rounds, launches=counter, name="ablation",
                                    srht_rows=rows)
        return call

    calls = {name: port_call(lib) for name, lib in libs.items() if name != "parent"}
    if "parent" in libs:
        calls["parent"] = lambda: parent_gram(libs["parent"], args.family, keys, X, m, rows)
    if args.family in ("gaussian", "rademacher"):
        calls["sketch_apply"] = lambda: cuda.sketch_apply(args.family, keys, X, m, rounds=rounds, launches=counter,
                                                          name="ablation")
    try:
        want = port_call(cuda._library("sketch_gram"))()
        same = {name: bool(torch.equal(calls[name](), want)) for name in libs if name == "full" or name in extra}
        runs = time_calls(calls, args.reps)
        plain = plain_grams(args.family, keys, X, m, rows)
        errors = {}
        for name in ("full", *CHAINS, "parent", *extra):
            if name in calls:
                G = calls[name]()
                errors[name] = max(entry_err(G[w], plain[w]) for w in range(args.q))
    finally:
        if own is None:
            cuda._LIBS.pop("sketch_gram", None)
        else:
            cuda._LIBS["sketch_gram"] = own

    p = cuda.plan_dense_gram(n, m, d)
    plan = {"splits": p.n_splits, "block_cols": p.block_cols, "cluster": p.cluster, "clusters": p.clusters,
            "blocks": p.blocks}
    line = {"family": args.family, "n": n, "d": d, "m": m, "q": args.q, "plan": plan,
            "bitwise_the_port": same, "entry_err": errors,
            "median_ms": {k: statistics.median(v) for k, v in runs.items()}, "runs_ms": runs}
    line["mma_floor_ms"] = PASSES[args.family] * 2 * m * n * d * args.q / (rate * 1e9)
    # Integer work: a threefry an entry (Gaussian); a sign word (a threefry, or the
    # SRHT's AND, popcount and XOR) per 32 entries, and the SRHT's diagonal.
    per_entry = {"gaussian": THREEFRY_OPS, "rademacher": THREEFRY_OPS / 32, "srht": 3 / 32}[args.family]
    int_ops = m * n * args.q * per_entry + (n * args.q * THREEFRY_OPS if args.family == "srht" else 0)
    line["rng_bound_ms"] = int_ops / PEAK_INT32_OPS * 1e3
    print(json.dumps(line), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("a") as f:
        f.write(json.dumps(head) + "\n" + json.dumps(line) + "\n")
    return 0 if same["full"] else 1


if __name__ == "__main__":
    sys.exit(main())
