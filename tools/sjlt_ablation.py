#!/usr/bin/env python3
"""Time the SJLT passes (``src/repro_torch/csrc/sjlt_gram.cu``) with parts of
their work left out, beside the earlier single-pass kernel, at the path shapes.

Run from the root of a checkout, on a machine with one CUDA card and ``nvcc``:

    python3 tools/sjlt_ablation.py [--shapes fig3a,fig3a_q2,hybrid,fig4a] [--reps 5]
                                   [--variants full,no_draw,...] [--extra NAME=FILE.cu ...]
                                   [--parent FILE.cu] [--out PATH]

The SJLT sketch runs as a bin pass (each (row, t) pair drawn once per worker and
written to a list binned by m-tile and owner class), a scatter pass (a producer
warp brings each chunk's list and X rows in on an mbarrier ring, consumer warps
add them into a shared-memory accumulator), then the split reduction (and, for a
Gram, the Gram pass). The source's ``SJLT_ABLATE`` bits leave out the draw (1:
the bin pass hashes the pair index instead), the X copy (2), the adds (4), the
bin pass (8) or the scatter pass (16); each variant below sets some of them
(``VARIANTS``). ``handoffs_only`` keeps the scatter pass's ring, its list copies
and the reduction; ``producers_1`` and ``producers_2`` stage X with fewer
producer warps than the port's 4 (``SJLT_PRODUCER_WARPS``), and ``adds_twice``
makes each chunk's adds twice
(``SJLT_CONSUMER_REPS``), so its excess over ``full`` is what the adds cost
where nothing else holds them. ``--extra`` adds a patched copy of the source, built whole,
as one more variant (held bitwise against the port's build). ``--parent`` builds
the ``sjlt_gram.cu`` of the commit before this design (``git archive 0660cfc``:
one pass whose every block redraws its pairs) and times it whole on the plan it
had. Each variant's error against the plain version is printed:
max |ΔG_ij|/√(G_ii·G_jj) for a Gram, max over columns of max_i |Δ|/rms_i for an
S·A (ablated variants are wrong by design).

Shapes: ``fig3a`` (the Gram of X = [A | b], n = 500,000, d′ = 251, m = 2,500,
s = 20, q = 1), ``fig3a_q2`` (the same at q = 2), ``hybrid`` (the S·A of its
first m′ = 25,000 rows) and ``fig4a`` (the S·A of X = Aᵀ, 1,000 × 50, m = 200).
Every call is timed with CUDA events, the variants interleaved (their order
rotated each repetition), one call a repetition, the median kept and every run
printed; ``kernel_ms`` is each variant's device time by kernel under
``torch.profiler`` (mean of 3 calls), so the event time splits into the passes
and the launch path; ``in_a_row`` the host's enqueue time and the event time a
call over calls issued back to back (50 at FIG4A's size, where a call is
host-bound). ``smem_floor_ms`` is the scatter's shared-memory traffic (3 wavefronts
per 32 adds: the accumulator read and write and the X row) at one wavefront a
cycle on every SM at ``clocks.max.sm``; ``bytes_ms`` X read once and the result
written once at 3.35 TB/s.

Prints one JSON line a shape (also appended to ``--out``) and, first, the card's
name and power limit. Nothing here is on a solve path.
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
    "full": "-DSJLT_ABLATE=0",
    "no_draw": "-DSJLT_ABLATE=1",
    "no_x": "-DSJLT_ABLATE=2",
    "no_scatter": "-DSJLT_ABLATE=4",
    "bin_only": "-DSJLT_ABLATE=16",  # the bin pass and the reduction
    "handoffs_only": "-DSJLT_ABLATE=14",  # no bin pass, X copy or adds: the ring, its list copies, the reduction
    "producers_1": "-DSJLT_PRODUCER_WARPS=1",
    "producers_2": "-DSJLT_PRODUCER_WARPS=2",
    "adds_twice": "-DSJLT_CONSUMER_REPS=2",  # each chunk's adds made twice: their own cost
}
S = 20  # FIG3A's nonzeros per data row
SHAPES = {  # name: (n, d, m, q, gram)
    "fig3a": (500_000, 251, 2_500, 1, True),
    "fig3a_q2": (500_000, 251, 2_500, 2, True),
    "hybrid": (25_000, 251, 2_500, 1, False),
    "fig4a": (1_000, 50, 200, 1, False),
}
PEAK_BYTES = 3.35e12


def build(variants: list[str], extra: dict[str, Path], parent: Path | None) -> tuple[dict, dict]:
    """One library per variant, all ``nvcc`` at once; and each build's kernels'
    registers and spills (ptxas)."""
    from repro_torch.kernels import cuda

    nvcc = cuda.nvcc_path()
    out_dir = cuda.BUILD_DIR / "sjlt_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {name: (cuda.CSRC / "sjlt_gram.cu", VARIANTS[name].split()) for name in variants}
    jobs.update({name: (path, []) for name, path in extra.items()})
    if parent is not None:
        jobs["parent"] = (parent, [])
    procs = {}
    for name, (src, defs) in jobs.items():
        so = out_dir / f"libsjlt_gram-{name}-{os.getpid()}.so"
        cmd = [nvcc, *cuda.NVCC_FLAGS, *defs, "-I", str(src.parent), "-I", str(cuda.CSRC), "-o", str(so), str(src)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, usage = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        if name == "parent":  # the entries as they were: (..., bucket_tile, chunk_rows, partial, out, stream)
            P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
            for entry in ("repro_sjlt_gram", "repro_sjlt_apply"):
                getattr(lib, entry).argtypes = [P, LL, I, P, I, I, I, F, LL, I, I, I, P, P, P]
                getattr(lib, entry).restype = I
            lib.repro_error_string.argtypes = [I]
            lib.repro_error_string.restype = ctypes.c_char_p
        else:
            cuda._declare("sjlt_gram", lib)
        libs[name] = lib
        usage[name] = {r["kernel"]: f"{r.get('registers')} regs, "
                                    f"spills {r.get('spill_stores')}/{r.get('spill_loads')} B"
                       for r in cuda.ptxas_usage(log) if "sjlt" in r["kernel"]}
    return libs, usage


def parent_plan(n: int, m: int, d: int, s: int) -> tuple[int, int, int, int]:
    """(n_splits, rows_per_split, bucket_tile, chunk_rows) of the parent's plan:
    m-tiles of at most 1,536 rows by 32 columns a block, chunks of
    min(128, 2048 // s) rows, splits of at least 16 chunks aiming at 528 blocks."""
    m_tiles = -(-m // 1536)
    chunk = min(128, 2048 // s)
    tiles = m_tiles * -(-d // 32)
    want = max(1, -(-528 // tiles))
    most = max(1, -(-n // (chunk * 16)))
    rows = -(-(-(-n // min(want, most))) // chunk) * chunk
    return -(-n // rows), rows, -(-m // m_tiles), chunk


def parent_call(lib, keys, X, m: int, s: int, gram: bool):
    """The parent's Grams (q, d, d) or S·X (q, m, d), all q workers in one call."""
    import torch

    from repro_torch.kernels import common, cuda

    n, d = X.shape
    q = keys.shape[0]
    n_splits, rows, bucket_tile, chunk = parent_plan(n, m, d, s)
    kw = cuda._u32_words(keys, X.device)
    out = torch.empty((q, d, d) if gram else (q, m, d), dtype=torch.float32, device=X.device)
    partial = torch.empty((q, n_splits * m * d), dtype=torch.float32, device=X.device)
    entry = lib.repro_sjlt_gram if gram else lib.repro_sjlt_apply
    code = entry(X.data_ptr(), n, d, kw.data_ptr(), q, m, s, common.inv_sqrt(s), rows, n_splits, bucket_tile,
                 chunk, partial.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cuda._check(lib, code, "parent sjlt launch")
    return out


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


def pipelined_ms(call, reps: int = 50) -> dict[str, float]:
    """``reps`` calls back to back, no synchronize between: the host's enqueue
    time a call, and the event time a call (the larger of the host's launch
    path and the device's time, as a caller issuing calls in a row sees it)."""
    import torch

    call()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        call()
    stop.record()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return {"enqueue_ms": host, "event_ms": start.elapsed_time(stop) / reps}


def kernel_ms(call, reps: int = 3) -> dict[str, float]:
    """Device ms a call spends in each kernel (by name), mean of ``reps`` calls
    under ``torch.profiler``; ``device`` sums them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0][:40]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    out["device"] = sum(out.values())
    return out


def error(out, want, gram: bool) -> float:
    """max |ΔG_ij|/√(G_ii·G_jj) for Grams, max over columns of max_i |Δ|/rms_i for S·X."""
    import torch

    out, want = out.double(), want.double()
    if gram:
        diag = torch.diagonal(want, dim1=-2, dim2=-1).clamp_min(0)
        return float(((out - want).abs() / (diag[..., :, None] * diag[..., None, :]).sqrt()).max())
    rms = want.pow(2).mean(dim=-2, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((out - want).abs() / rms).max())


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shapes", default=",".join(SHAPES), help=f"comma-separated subset of {', '.join(SHAPES)}")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=20260)
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "sjlt_ablation.jsonl")
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help=f"comma-separated subset of {', '.join(VARIANTS)} (always with full)")
    parser.add_argument("--extra", action="append", default=[], metavar="NAME=FILE.cu",
                        help="a patched copy of sjlt_gram.cu, built whole, as one more variant")
    parser.add_argument("--parent", type=Path, default=None, metavar="FILE.cu",
                        help="the sjlt_gram.cu of 0660cfc (one pass, every block redrawing its pairs), timed whole")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("sjlt_ablation: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    extra = {}
    for item in args.extra:
        name, _, path = item.partition("=")
        extra[name] = Path(path).resolve()
    variants = ["full"] + [v for v in args.variants.split(",") if v and v != "full"]
    shapes = [s for s in args.shapes.split(",") if s]
    unknown = (set(variants) - set(VARIANTS)) | (set(shapes) - set(SHAPES))
    if unknown:
        parser.error(f"unknown variants or shapes {sorted(unknown)}")

    from repro_torch.kernels import cuda
    from repro_torch.kernels.sjlt import ref as sref
    from repro_torch.utils import prng

    t0 = time.perf_counter()
    cuda.build(["sjlt_gram"])
    libs, usage = build(variants, extra, args.parent.resolve() if args.parent else None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    clock = max_sm_clock_hz()
    head = {"card": smi, "max_sm_clock_hz": clock, "build_s": time.perf_counter() - t0,
            "variants": {**{v: VARIANTS[v] for v in variants}, **{k: "extra" for k in extra}}, "ptxas": usage}
    print(json.dumps(head), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("a") as f:
        f.write(json.dumps(head) + "\n")

    rs = np.random.default_rng(args.seed)
    X_full = None
    ok = True
    counter: collections.Counter = collections.Counter()
    own = cuda._LIBS.get("sjlt_gram")
    for shape in shapes:
        n, d, m, q, gram = SHAPES[shape]
        if shape == "fig4a":
            X = torch.from_numpy(rs.standard_normal((n, d)).astype(np.float32)).cuda()
        else:
            if X_full is None:
                X_full = torch.from_numpy(rs.standard_normal((500_000, 251)).astype(np.float32)).cuda()
            X = X_full[:n].contiguous()
        keys = prng.worker_keys(prng.prng_key(args.seed + len(shape)), q)
        wrapper = cuda.sjlt_gram if gram else cuda.sjlt_apply

        def port_call(lib):
            def call():
                cuda._LIBS["sjlt_gram"] = lib
                return wrapper(keys, X, m, S, launches=counter, name="ablation")
            return call

        calls = {name: port_call(lib) for name, lib in libs.items() if name != "parent"}
        if "parent" in libs:
            calls["parent"] = lambda: parent_call(libs["parent"], keys, X, m, S, gram)
        try:
            want_port = port_call(cuda._library("sjlt_gram"))()
            same = {name: bool(torch.equal(calls[name](), want_port)) for name in ("full", *extra)}
            runs = time_calls(calls, args.reps)
            plain = torch.stack([(sref.sjlt_gram if gram else sref.sketch)(keys[w], X, m, S) for w in range(q)])
            errors = {name: error(calls[name](), plain, gram) for name in calls}
            by_kernel = {name: kernel_ms(calls[name]) for name in calls}
            in_a_row = {name: pipelined_ms(calls[name], 50 if n * d < 10**6 else 5) for name in calls}
        finally:
            if own is None:
                cuda._LIBS.pop("sjlt_gram", None)
            else:
                cuda._LIBS["sjlt_gram"] = own
        p = cuda.plan_sjlt(n, m, d, S)
        adds = n * S * d * q
        line = {"shape": shape, "n": n, "d": d, "m": m, "s": S, "q": q, "gram": gram,
                "plan": {"splits": p.n_splits, "m_tiles": p.m_tiles, "d_tiles": p.d_tiles,
                         "chunk_rows": p.chunk_rows, "blocks": p.blocks,
                         "workers_per_call": cuda.worker_chunk(n, m, d, 1 << 20, family="sjlt", s=S)},
                "parent_plan": dict(zip(("splits", "rows_per_split", "bucket_tile", "chunk_rows"),
                                        parent_plan(n, m, d, S))),
                "bitwise_the_port": same, "errors": errors,
                "median_ms": {k: statistics.median(v) for k, v in runs.items()}, "runs_ms": runs,
                "kernel_ms": by_kernel, "in_a_row": in_a_row,
                "smem_floor_ms": 3 * adds / 32 / (132 * clock) * 1e3,
                "bytes_ms": 4 * (n * d + q * (d * d if gram else m * d)) / PEAK_BYTES * 1e3}
        print(json.dumps(line), flush=True)
        with args.out.open("a") as f:
            f.write(json.dumps(line) + "\n")
        ok = ok and same["full"] and errors["full"] <= 1e-5
        del X, calls
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
