#!/usr/bin/env python3
"""Time the dense sketch→Gram kernels (``src/repro_torch/csrc/sketch_gram.cu``)
with parts of their work left out, to see what holds them back at one shape.

Run from the root of a checkout, on a machine with one CUDA card and ``nvcc``:

    python3 tools/gram_ablation.py [--family gaussian] [--shape N,D,M] [--q 1] [--reps 5]
                                   [--variants full,no_x,...] [--extra NAME=FILE.cu ...]
                                   [--parent FILE.cu] [--max-cluster N] [--out PATH]

``--family gaussian`` (the default) times the tensor-core pass
(``repro_gaussian_gram``): a split pass writes X once as TF32 hi and lo parts;
producer warps draw S, consumer warps copy the X tiles (bulk copies multicast
over a cluster of m-tiles) and multiply on the tensor cores; mbarrier rings hand
the steps over. ``rademacher`` and ``srht`` time the FFMA pass
(``repro_sketch_gram``), where every thread draws, loads X and multiplies in
turn, between block-wide barriers. The shape defaults to FIG3A's full n.

The source's ``SKETCH_GRAM_ABLATE`` bits leave out the draw (1), the X copy (2),
the split pass (4, tensor-core pass only) or the products (8), and every build
below sets some of them (``VARIANTS``); ``long_chains`` instead builds one chain
a split (no second level of the two-level sum; for the Gaussian its error is
printed). Every variant keeps the hand-offs, so ``handoffs_only`` is the cost of
the pipeline itself. ``--extra`` adds a patched copy of the source, built whole,
as one more variant (held bitwise against the port's build). Beside the Gaussian
variants two more calls are timed on the same keys and X: ``sketch_apply``, the
dense S·A kernel (``csrc/sketch_apply.cu``: S·X alone, no Gram), and with
``--parent`` a ``sketch_gram.cu`` from before the tensor-core pass, whose
Gaussian Gram is family 0 of ``repro_sketch_gram`` on ``cuda.plan_splits`` (to
time the kernel the tensor-core pass replaced: ``git archive 27a266b`` holds
it). Each call is timed with CUDA events, the variants interleaved (their order
rotated each repetition), one call a repetition (``--reps`` of them, the median
kept, every run printed). ``mma_floor_ms`` is the tensor-core pass's TF32
products at ``mma.sync``'s own rate, measured in the same run
(``csrc/mma_probe.cu``); ``rng_bound_ms`` the draw at 16.7 T integer operations a
second.

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
    "long_chains": "-DSKETCH_GRAM_CHAIN_STEPS=1048576 -DSKETCH_GRAM_FLUSH_STEPS=1048576",
}
FIG3A = (500_000, 251, 2_500)  # n, d' = d + 1, m
INT_OPS_PER_ENTRY = 77  # one threefry2x32 at 20 rounds
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
        if name == "parent":  # the entry as it was before the tensor-core pass
            P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
            lib.repro_sketch_gram.argtypes = [I, P, LL, I, P, P, I, I, F, I, LL, I, P, P, P]
            lib.repro_sketch_gram.restype = I
            lib.repro_error_string.argtypes = [I]
            lib.repro_error_string.restype = ctypes.c_char_p
        else:
            cuda._declare("sketch_gram", lib)
        libs[name] = lib
        usage[name] = {r["kernel"]: f"{r.get('registers')} regs, "
                                    f"spills {r.get('spill_stores')}/{r.get('spill_loads')} B"
                       for r in cuda.ptxas_usage(log) if "partial_kernel" in r["kernel"]}
    return libs, usage


def parent_gram(lib, keys, X, m: int):
    """The parent's Gaussian Grams (q, d, d): family 0 of its ``repro_sketch_gram``
    (the FFMA pass) on ``cuda.plan_splits``, all q workers in one call."""
    import torch

    from repro_torch.kernels import common, cuda

    n, d = X.shape
    q = keys.shape[0]
    n_splits, rows = cuda.plan_splits(n, m, d)
    kw = cuda._u32_words(keys, X.device)
    G = torch.empty((q, d, d), dtype=torch.float32, device=X.device)
    partial = torch.empty((q, n_splits * m * d), dtype=torch.float32, device=X.device)
    code = lib.repro_sketch_gram(0, X.data_ptr(), n, d, kw.data_ptr(), None, q, m, common.inv_sqrt(m),
                                 common.rng_rounds(), rows, n_splits, partial.data_ptr(), G.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
    cuda._check(lib, code, "parent sketch_gram launch")
    return G


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
                        help="a sketch_gram.cu from before the tensor-core pass, timed whole (Gaussian only)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gram_ablation: CUDA is not available", file=sys.stderr)
        return 2
    gaussian = args.family == "gaussian"
    if args.parent is not None and not gaussian:
        parser.error("--parent times the Gaussian Gram only")
    torch.backends.cuda.matmul.allow_tf32 = False
    extra = {}
    for item in args.extra:
        name, _, path = item.partition("=")
        extra[name] = Path(path).resolve()
    variants = ["full"] + [v for v in args.variants.split(",") if v and v != "full"]
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        parser.error(f"unknown variants {sorted(unknown)}")
    if not gaussian:
        variants = [v for v in variants if v != "no_split"]  # the FFMA pass has no split pass
    from apply_ablation import mma_tflops

    from repro_torch.kernels import common, cuda
    from repro_torch.kernels.gaussian import ref
    from repro_torch.utils import prng

    if args.max_cluster:
        cuda.GRAM_MAX_CLUSTER = args.max_cluster
        cuda.plan_gaussian_gram.cache_clear()
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
        calls["parent"] = lambda: parent_gram(libs["parent"], keys, X, m)
    if gaussian:
        calls["sketch_apply"] = lambda: cuda.sketch_apply("gaussian", keys, X, m, rounds=rounds, launches=counter,
                                                          name="ablation")
    try:
        want = port_call(cuda._library("sketch_gram"))()
        same = {name: bool(torch.equal(calls[name](), want)) for name in libs if name == "full" or name in extra}
        runs = time_calls(calls, args.reps)
        errors = {}
        if gaussian:
            G64 = [ref.gaussian_gram(keys[w], X, m) for w in range(args.q)]
            for name in ("full", "long_chains", "parent"):
                if name in calls:
                    G = calls[name]()
                    errors[name] = max(entry_err(G[w], G64[w]) for w in range(args.q))
    finally:
        if own is None:
            cuda._LIBS.pop("sketch_gram", None)
        else:
            cuda._LIBS["sketch_gram"] = own

    if gaussian:
        p = cuda.plan_gaussian_gram(n, m, d)
        plan = {"splits": p.n_splits, "block_cols": p.block_cols, "cluster": p.cluster, "clusters": p.clusters,
                "blocks": p.blocks}
    else:
        plan = {"splits": cuda.plan_splits(n, m, d)[0]}
    line = {"family": args.family, "n": n, "d": d, "m": m, "q": args.q, "plan": plan,
            "bitwise_the_port": same, "entry_err": errors,
            "median_ms": {k: statistics.median(v) for k, v in runs.items()}, "runs_ms": runs}
    if gaussian:
        line["mma_floor_ms"] = 3 * 2 * m * n * d * args.q / (rate * 1e9)
        line["rng_bound_ms"] = m * n * args.q * INT_OPS_PER_ENTRY / PEAK_INT32_OPS * 1e3
    print(json.dumps(line), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("a") as f:
        f.write(json.dumps(head) + "\n" + json.dumps(line) + "\n")
    return 0 if same["full"] else 1


if __name__ == "__main__":
    sys.exit(main())
