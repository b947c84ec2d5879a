#!/usr/bin/env python3
"""Device time of row 12b (the SJLT S·A of few, long columns) by pass, and of
the CountSketch's adjoint over the kept pair list against the one that draws
the pairs again.

Run from the root of a checkout, on a machine with one CUDA card and ``nvcc``:

    python3 tools/sjlt_long_profile.py [--shapes 20.1:0.01,26:0.1,...] [--reps 5]
                                       [--parent-src DIR] [--ablate V,V] [--adjoint-reps 2]

A shape ``k:ratio`` is a CountSketch (s = 1) of one N(0, 1) vector of D = 2^k
coordinates (``20.1``: gradcomp_bench's D = 2^20 + 2^16) at m = ceil(ratio·D)
sketch rows, gradient compression's shape; the default is the seven shapes
D = 2^20 + 2^16 at 0.01, 0.1, 0.25, 2^26 at 0.1 and 2^28 at 0.01, 0.1, 0.25. For
each it times ``ops.sjlt_apply`` with CUDA events (the mean of ``--reps`` calls
after a warm-up), then one call under ``torch.profiler`` split by pass (count,
the two scans, scatter, with two levels count_groups and scatter_groups,
accumulate), beside the library's ``index_add_`` of the signed entries (float
atomics) on the same vector. ``--parent-src`` takes the
``src`` directory of an earlier checkout (e.g. a ``git archive`` of the parent
commit unpacked under ``build/``), builds its ``sjlt_gram.cu`` and times its
wrapper ``kernels/cuda.py sjlt_apply_long`` in turns with this tree's
``ops.sjlt_apply`` (this, parent, this, parent), its output held bitwise
against this tree's. ``--ablate`` builds ``sjlt_gram.cu`` with parts of the
scatter pass's work left out (``SJLT_LONG_ABLATE``; the results are then
wrong) and times each beside the port, on the port's plan. Then the adjoint Sᵀ·y of the payload: ``operators.sjlt_adjoint_kept``
over the pair list the S·A kept, and ``SJLTOp.adjoint`` (the pairs drawn
again), each timed with CUDA events and held bitwise against the other. Prints
the card's name and power limit, then one JSON line a shape.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = "20.1:0.01,20.1:0.1,20.1:0.25,26:0.1,28:0.01,28:0.1,28:0.25"
# kernel -> pass: this tree's (one level: count, scatter; two: count and scatter into the
# group list, then count_groups and scatter_groups over it), and the parent's three
PASSES = {"sjlt_long_count_kernel<true>": "count", "sjlt_long_count_kernel<false>": "count_groups",
          "sjlt_long_scan_chunks_kernel": "scan_chunks", "sjlt_long_scan_parts_kernel": "scan_parts",
          "sjlt_long_scatter_kernel<true, false>": "scatter", "sjlt_long_scatter_kernel<true, true>": "scatter",
          "sjlt_long_scatter_kernel<false, false>": "scatter_groups",
          "sjlt_long_accumulate_kernel": "accumulate", "sjlt_long_finish_kernel": "finish",
          "sjlt_long_scale_kernel": "scale", "sjlt_long_fixed_kernel": "fixed_point"}


def event_ms(fn, reps: int) -> float:
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def by_pass_ms(fn) -> dict:
    """Device ms of one call by kernel, under the names of PASSES where they have one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:  # keep every event of the window (newer profilers clear them at a cycle's end)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True)
    except TypeError:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")[:60]
            name = PASSES.get(name, name)
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def shape_of(spec: str) -> tuple[int, int, float]:
    k, ratio = spec.split(":")
    D = 2**20 + 2**16 if k == "20.1" else 1 << int(k)
    return D, max(1, math.ceil(float(ratio) * D)), float(ratio)


def parent_wrapper(src: Path):
    """``sjlt_apply_long`` of an earlier checkout's ``src/repro_torch/kernels/cuda.py``
    (its whole wrapper, its own ``csrc`` and build directory), loaded beside
    this tree's as a module of its own."""
    import importlib.util

    path = src / "repro_torch" / "kernels" / "cuda.py"
    spec = importlib.util.spec_from_file_location("parent_cuda", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    module.build(["sjlt_gram"])
    return module


def parent_call(module, key, X, m: int):
    """The earlier wrapper's S·X (m, 1) for one key."""
    import collections

    launches = collections.Counter()
    return lambda: module.sjlt_apply_long(key.reshape(1, 2), X, m, 1, launches=launches, name="parent")[0]


def build_ablations(values: list[str]) -> dict:
    """``sjlt_gram.cu`` built with each ``SJLT_LONG_ABLATE`` value (all at
    once), each library bound as the port's is."""
    import ctypes

    from repro_torch.kernels import cuda

    out_dir = ROOT / "build" / "sjlt_long_ablations"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for value in values:
        name = f"ablate{value}"
        so = out_dir / f"libsjlt_gram_{name}.so"
        cmd = [cuda.nvcc_path(), *cuda.NVCC_FLAGS, f"-DSJLT_LONG_ABLATE={value}", "-I", str(cuda.CSRC), "-o",
               str(so), str(cuda.CSRC / "sjlt_gram.cu")]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(so))
        cuda._declare("sjlt_gram", libs[name])
    return libs


def ablated_call(lib, key, X, m: int):
    """``repro_sjlt_apply_long`` of an ablated library for one key, as the port's wrapper calls it."""
    import torch

    from repro_torch.kernels import common, cuda

    n, d = X.shape
    plan = cuda.plan_sjlt_long(n, m, d, 1)
    words = cuda._host_key_words(key.reshape(1, 2))
    size = cuda._long_scratch_bytes(lib, n, d, m, 1, plan)
    scratch = torch.empty(-(-(size + 4 * plan.pairs) // 8), dtype=torch.int64, device=X.device)
    out = torch.empty((m, d), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        code = lib.repro_sjlt_apply_long(X.data_ptr(), n, d, words, 1, m, 1, common.inv_sqrt(1), 0, plan.bucket_tile,
                                         plan.group_parts, plan.sub, plan.chunk_pairs, plan.cols,
                                         scratch.data_ptr() + size, scratch.data_ptr(), size, out.data_ptr(), stream)
        cuda._check(lib, code, "ablated repro_sjlt_apply_long")
        return out

    return call


def library_call(key, X, m: int):
    """One ``index_add_`` of the signed entries (float atomics), its operands drawn before."""
    import torch

    from repro_torch.kernels import common

    k0, k1 = common.key_words(key)
    D = X.shape[0]
    idx = torch.empty(D, dtype=torch.int64, device=X.device)
    src = torch.empty((D, 1), device=X.device)
    for j0 in range(0, D, 1 << 22):  # the int64 threefry of 2^22 rows at a time
        j1 = min(D, j0 + (1 << 22))
        buckets, signs = common.sjlt_counter_params(k0, k1, torch.arange(j0, j1, device=X.device), 1, m)
        idx[j0:j1], src[j0:j1] = buckets[:, 0], signs * X[j0:j1]
    return lambda: torch.zeros((m, 1), device=X.device).index_add_(0, idx, src)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shapes", default=SHAPES)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--adjoint-reps", type=int, default=2)
    parser.add_argument("--parent-src", type=Path, default=None, metavar="DIR")
    parser.add_argument("--ablate", default="", metavar="V,V",
                        help="SJLT_LONG_ABLATE values to build and time beside the port (4: the scatter passes "
                             "write no entry to device memory)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("sjlt_long_profile: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core import operators, sketches
    from repro_torch.kernels import cuda
    from repro_torch.kernels.sjlt import ops
    from repro_torch.utils import prng

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    parent = parent_wrapper(args.parent_src.resolve()) if args.parent_src else None
    ablations = build_ablations([v for v in args.ablate.split(",") if v])
    key = prng.prng_key(23)
    for spec in args.shapes.split(","):
        D, m, ratio = shape_of(spec)
        X = torch.randn((D, 1), generator=torch.Generator(device="cuda").manual_seed(D), device="cuda")
        this = lambda: ops.sjlt_apply(key, X, m, 1)  # noqa: E731
        out = this()
        row = {"tool": "sjlt_long_profile", "card": smi, "D": D, "m": m, "ratio": ratio,
               "plan": {k: v for k, v in vars(cuda.plan_sjlt_long(D, m, 1, 1)).items()}}
        if parent is not None:
            old = parent_call(parent, key, X, m)
            turns = [event_ms(f, args.reps) for f in (this, old, this, old)]
            row.update(ms_turns=turns, ms=(turns[0] + turns[2]) / 2, parent_ms=(turns[1] + turns[3]) / 2,
                       parent_bitwise=bool(torch.equal(old(), out)),
                       parent_device_ms_by_pass=by_pass_ms(old))
        else:
            row["ms"] = event_ms(this, args.reps)
        row["device_ms_by_pass"] = by_pass_ms(this)
        if ablations:
            row["ablations"] = {}
            for v, lib in ablations.items():
                call = ablated_call(lib, key, X, m)
                row["ablations"][v] = {"ms": event_ms(call, args.reps), "bitwise": bool(torch.equal(call(), out)),
                                       "device_ms_by_pass": by_pass_ms(call)}
                del call
        row["device_ms"] = sum(row["device_ms_by_pass"].values())
        row["rerun_bitwise"] = bool(torch.equal(this(), out))
        library = library_call(key, X, m)
        row["library_index_add_ms"] = event_ms(library, args.reps)
        del library
        # the adjoint of the payload: over the kept pair list, and drawn again
        op = operators.make_operator(sketches.SketchSpec("sjlt", m, s=1, use_kernel=True), key, D, device="cuda")
        payload, kept_adjoint = op.apply_with_adjoint(X[:, 0])
        y = payload.clone()
        row["kept_adjoint_ms"] = event_ms(lambda: kept_adjoint(y), args.adjoint_reps)
        row["redraw_adjoint_ms"] = event_ms(lambda: op.adjoint(y), args.adjoint_reps)
        row["adjoint_bitwise"] = bool(torch.equal(kept_adjoint(y), op.adjoint(y)))
        del X, out, payload, kept_adjoint, y
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
