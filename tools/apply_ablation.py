#!/usr/bin/env python3
"""Time the dense S·A kernel (``src/repro_torch/csrc/sketch_apply.cu``) with parts
of its work left out, to see what holds it back at each path shape.

Run from the root of a checkout, on a machine with one CUDA card and ``nvcc``:

    python3 tools/apply_ablation.py [--reps 7] [--out PATH] [--variants full,no_x,...]
                                    [--extra NAME=FILE.cu ...]

The kernel has two roles: producer warps draw their block's slice of each S tile
and gather the cluster's whole tile through distributed shared memory; consumer
warps stage X with ``cp.async`` and multiply on the tensor cores; mbarrier rings
hand the steps over. The source's ``SKETCH_APPLY_ABLATE`` bits leave out the
draw (1), the gather (2), the X staging (4) or the products (8), and every build
below sets some of them (``VARIANTS``). Every variant keeps the hand-offs, so
``handoffs_only`` is the cost of the pipeline itself. ``--extra`` adds a patched
copy of the source, built whole, as one more variant. Each shape is timed with
CUDA events, the variants interleaved (their order rotated each repetition), one
call a repetition (``--reps`` of them, the median kept, every run printed);
FIG4A's shapes, where a call is shorter than its host set-up, take 20 calls a
repetition. The ``full`` build (and each ``--extra``) is held bitwise against
the port's own build.
``mma_floor_ms`` is the shape's TF32 products at ``mma.sync``'s own rate,
measured in the same run (``csrc/mma_probe.cu``).

Prints one JSON line per shape (also written to ``--out``) and, first, the
card's name and power limit. Ablated variants compute wrong results by design;
nothing here is on a solve path.
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

VARIANTS = {
    "full": 0,
    "no_draw": 1,
    "no_gather": 2,
    "no_x": 4,
    "no_mma": 8,
    "consumers_only": 1 | 2,  # X staging, products, hand-offs
    "mma_only": 1 | 2 | 4,  # products, hand-offs
    "producers_only": 4 | 8,  # draw, gather, hand-offs
    "handoffs_only": 1 | 2 | 4 | 8,
}
# (family, n, d, m, label): the dense S·A at the shapes its paths give it.
SHAPES = (
    ("gaussian", 11_556, 2_000, 4_000, "fig4b_At"),
    ("gaussian", 8_000, 2_000, 4_000, "fig4b_hybrid_rows"),
    ("gaussian", 25_000, 251, 2_500, "fig3a_mprime_rows"),
    ("rademacher", 25_000, 251, 2_500, "fig3a_mprime_rows"),
    ("gaussian", 500_000, 251, 2_500, "fig3a_full_n"),
    ("rademacher", 500_000, 251, 2_500, "fig3a_full_n"),
    ("gaussian", 1_000, 50, 200, "fig4a_At"),
    ("rademacher", 1_000, 50, 200, "fig4a_At"),
)
TF32_PASSES = {"gaussian": 3, "rademacher": 2}
SMALL_CALLS = 20  # calls a repetition where one call is host-bound


def build(variants: list[str], extra: dict[str, Path]) -> tuple[dict[str, ctypes.CDLL], dict[str, dict]]:
    """One library per variant, all ``nvcc`` at once, into the build directory;
    and each variant's kernels' registers and spills (ptxas)."""
    from repro_torch.kernels import cuda

    nvcc = cuda.nvcc_path()
    out_dir = cuda.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in variants:
        jobs[name] = (cuda.CSRC / "sketch_apply.cu", [f"-DSKETCH_APPLY_ABLATE={VARIANTS[name]}"])
    for name, path in extra.items():
        jobs[name] = (path, [])
    procs = {}
    for name, (src, defs) in jobs.items():
        so = out_dir / f"libsketch_apply-{name}-{os.getpid()}.so"
        cmd = [nvcc, *cuda.NVCC_FLAGS, *defs, "-I", str(cuda.CSRC), "-o", str(so), str(src)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, usage = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        cuda._declare("sketch_apply", lib)
        libs[name] = lib
        usage[name] = {r["kernel"]: f"{r.get('registers')} regs, spills {r.get('spill_stores')}/{r.get('spill_loads')} B"
                       for r in cuda.ptxas_usage(log) if "sketch_apply_kernel" in r["kernel"]}
    return libs, usage


def mma_tflops() -> float:
    import torch

    from repro_torch.kernels import cuda

    run, flops = cuda.mma_rate(4 * 132, 2000)
    run()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        run()
    stop.record()
    torch.cuda.synchronize()
    return 3 * flops / start.elapsed_time(stop) / 1e9


def time_shape(libs, family, n, d, m, reps, seed):
    import numpy as np
    import torch

    from repro_torch.kernels import common, cuda
    from repro_torch.utils import prng

    rs = np.random.default_rng(seed)
    X = torch.from_numpy(rs.standard_normal((n, d)).astype(np.float32)).cuda()
    keys = prng.worker_keys(prng.prng_key(seed), 1)
    counter: collections.Counter = collections.Counter()
    own = cuda._LIBS.get("sketch_apply")

    def call(lib):
        cuda._LIBS["sketch_apply"] = lib
        return cuda.sketch_apply(family, keys, X, m, rounds=common.rng_rounds(), launches=counter, name="ablation")

    try:
        want = cuda.sketch_apply(family, keys, X, m, rounds=common.rng_rounds(), launches=counter, name="port")
        same = {name: bool(torch.equal(call(lib), want)) for name, lib in libs.items()
                if name == "full" or name not in VARIANTS}
        calls = SMALL_CALLS if n * d < 10**6 else 1
        names = list(libs)
        runs = {name: [] for name in names}
        for name in names:
            call(libs[name])  # warm-up
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for r in range(reps):
            for name in names[r % len(names):] + names[:r % len(names)]:
                torch.cuda.synchronize()
                start.record()
                for _ in range(calls):
                    call(libs[name])
                stop.record()
                torch.cuda.synchronize()
                runs[name].append(start.elapsed_time(stop) / calls)
    finally:
        if own is None:
            cuda._LIBS.pop("sketch_apply", None)
        else:
            cuda._LIBS["sketch_apply"] = own
    plan = cuda.plan_apply(n, m, d)
    return same, calls, runs, plan


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=7)
    parser.add_argument("--seed", type=int, default=20260)
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "apply_ablation.jsonl")
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help=f"comma-separated subset of {', '.join(VARIANTS)} (always with full)")
    parser.add_argument("--extra", action="append", default=[], metavar="NAME=FILE.cu",
                        help="a patched copy of sketch_apply.cu, built whole, as one more variant")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("apply_ablation: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    extra = {}
    for item in args.extra:
        name, _, path = item.partition("=")
        extra[name] = Path(path).resolve()
    from repro_torch.kernels import cuda

    t0 = time.perf_counter()
    cuda.build(["sketch_apply", "mma_probe"])
    variants = ["full"] + [v for v in args.variants.split(",") if v and v != "full"]
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        parser.error(f"unknown variants {sorted(unknown)}")
    libs, usage = build(variants, extra)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    rate = mma_tflops()
    head = {"card": smi, "build_s": time.perf_counter() - t0, "mma_sync_tf32_tflops": rate,
            "variants": {**{v: VARIANTS[v] for v in variants}, **{k: "extra" for k in extra}}, "ptxas": usage}
    print(json.dumps(head), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    ok = True
    with args.out.open("w") as f:
        f.write(json.dumps(head) + "\n")
        for family, n, d, m, label in SHAPES:
            same, calls, runs, plan = time_shape(libs, family, n, d, m, args.reps, args.seed)
            ok &= same["full"]
            floor = TF32_PASSES[family] * 2 * m * n * d / (rate * 1e9)
            line = {"shape": label, "family": family, "n": n, "d": d, "m": m,
                    "plan": {"splits": plan.n_splits, "rows_per_split": plan.rows_per_split,
                             "block_cols": plan.block_cols, "cluster": plan.cluster, "blocks": plan.blocks},
                    "bitwise_the_port": same, "calls_per_run": calls, "mma_floor_ms": floor,
                    "median_ms": {k: statistics.median(v) for k, v in runs.items()}, "runs_ms": runs}
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
