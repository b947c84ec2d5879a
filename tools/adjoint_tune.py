#!/usr/bin/env python3
"""Time the kept-S Gaussian adjoint (``src/repro_torch/csrc/adjoint.cu``,
``repro_adjoint_kept``) built with other tuning switches and run on other
splits, beside the library's product and the redraw kernel, at the path shapes;
and the host cost of each piece of its wrapper.

Run from the root of a checkout, on a machine with one CUDA card and ``nvcc``:

    python3 tools/adjoint_tune.py [--shapes fig4b,hybrid,fig4a] [--variants port,u2s3,...]
                                  [--splits 8,16,32,64] [--reps 5] [--out PATH]

The kernel streams its split of S's rows in groups of ``ADJOINT_KEPT_UNROLL``
rows in a ring of ``ADJOINT_KEPT_STAGES`` groups held in registers, with the
loads of ``ADJOINT_KEPT_LOAD`` (0: not in L1, 256-byte L2 prefetch; 1: not in
L1, the port's; 2: ``__ldg``). Each variant of ``VARIANTS`` builds the source
with other values; each runs on the port's splits (``cuda.plan_adjoint``, where
it is bitwise the port's build, which the tool checks) and on each count of
``--splits`` (rows ``ceil(m / splits)``). S is the one a forward S·A kept
(``gaussian_sketch_keep``), Y (m, 1) Gaussian. Every call is timed with CUDA
events over 50 calls in a row, the variants interleaved, the median of
``--reps`` rounds kept; ``library_ms`` is ``torch.matmul(S[:, :n].T, Y)`` and
``redraw_ms`` the redraw kernel (``gaussian_adjoint``, S drawn again), in the
same rounds. ``bytes_ms``: S, Y and the output moved once at 3.35 TB/s.

``host_us`` (at FIG4A's 200 × 1,000, where a call is host-bound): host
microseconds a call, over 3,000 calls in a row, of each piece of the wrapper
(the output's allocation, the raw stream handle, the checks, the plan, the
ctypes launch) and of the whole wrapper, the ops-level call, the redraw
wrapper, the library's product and the forward S·A of FIG4A's Aᵀ with and without
the store of S; ``event_ms`` the same calls' event time;
in a fresh process, after ``torch.cuda.set_sync_debug_mode`` was set and reset,
and after a ``torch.profiler`` session as well.

Prints the card's name and power limit, then one JSON line a shape and one for
the host costs (also appended to ``--out``). Nothing here is on a solve path.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

U, ST, LD = "-DADJOINT_KEPT_UNROLL=", "-DADJOINT_KEPT_STAGES=", "-DADJOINT_KEPT_LOAD="
VARIANTS = {
    "port": [],
    "u2s2": [U + "2"], "u2s3": [U + "2", ST + "3"], "u2s4": [U + "2", ST + "4"],
    "u4s3": [ST + "3"], "u4s4": [ST + "4"], "u8s2": [U + "8"], "u1s8": [U + "1", ST + "8"],
    "load0": [LD + "0"], "load2": [LD + "2"],
}
SHAPES = {"fig4b": (4000, 11_556), "hybrid": (4000, 8000), "fig4a": (200, 1000)}  # (m, n), k = 1
CALLS = 50


def event_ms(fn, calls: int = CALLS) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls


def host_us(fn, calls: int = 3000) -> float:
    import torch

    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def build(names, out_dir: Path) -> dict:
    """Each variant's library (all nvcc at once) with its ctypes entry, and its
    registers and spills."""
    from repro_torch.kernels import cuda

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda.nvcc_path()
    procs = {}
    for name in names:
        cmd = cuda.nvcc_command(nvcc, "adjoint", out_dir / f"libadjoint_{name}.so")
        procs[name] = subprocess.Popen(cmd[:1] + VARIANTS[name] + cmd[1:], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs, usage = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"libadjoint_{name}.so"))
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_adjoint_kept.argtypes = [P, LL, P, I, I, LL, I, I, P, I, P]
        lib.repro_adjoint_kept.restype = I
        libs[name] = lib
        usage[name] = [r for r in cuda.ptxas_usage(log) if "kept" in r["kernel"]]
    return {"libs": libs, "ptxas": usage}


def shape_rows(tag: str, m: int, n: int, libs: dict, split_counts, reps: int, seed: int) -> dict:
    import torch

    from repro_torch.kernels import cuda
    from repro_torch.kernels.gaussian import ops
    from repro_torch.utils import prng

    g = torch.Generator(device="cuda").manual_seed(seed)
    key = prng.worker_key(prng.prng_key(seed), n)
    _, S = ops.gaussian_sketch_keep(key, torch.randn((n, 8), generator=g, device="cuda"), m)
    Y = torch.randn((m, 1), generator=g, device="cuda")
    want = ops.gaussian_adjoint_kept(S, Y, n)
    plans = {"plan": cuda.plan_adjoint(m, n, 1)}
    for c in split_counts:
        rows = -(-m // min(c, m))
        plans[f"s{-(-m // rows)}"] = (-(-m // rows), rows)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((n, 1), device="cuda")
    times: dict = {}
    bitwise = {}
    calls = {}
    for name, lib in libs.items():
        for pname, (ns, rows) in plans.items():
            def call(lib=lib, ns=ns, rows=rows):
                return lib.repro_adjoint_kept(S.data_ptr(), S.shape[1], Y.data_ptr(), m, 1, n, rows, ns,
                                              out.data_ptr(), 0, stream)
            if call():
                raise RuntimeError(f"{name} refused splits {ns} x {rows}")
            if pname == "plan":
                bitwise[name] = bool(torch.equal(out, want))
            calls[f"{name}/{pname}"] = call
    calls["library"] = lambda: torch.matmul(S[:, :n].T, Y)
    calls["redraw"] = lambda: ops.gaussian_adjoint(key, Y, n)
    order = list(calls)
    for r in range(reps):
        for label in order[r % len(order):] + order[: r % len(order)]:
            times.setdefault(label, []).append(event_ms(calls[label]))
    med = {label: statistics.median(v) for label, v in times.items()}
    return {"shape": tag, "m": m, "n": n, "k": 1, "plan": plans["plan"], "bytes_ms": 4 * (m * n + m + n) / 3.35e12 * 1e3,
            "library_ms": med["library"], "redraw_ms": med["redraw"], "port_ms": med["port/plan"],
            "fastest": sorted((v, k) for k, v in med.items())[:8], "ms": med, "runs": times,
            "bitwise_port_on_plan": bitwise}


def host_costs(seed: int, state: str) -> dict:
    """Host microseconds a call of each piece of the kept adjoint's wrapper at FIG4A,
    in a process in ``state``: "fresh"; "after_sync_debug", once
    ``torch.cuda.set_sync_debug_mode`` has been set to "error" and back; then
    "after_profiler", once a ``torch.profiler`` session has run as well (as
    ``chip_smoke.py`` has done both by its adjoint phase)."""
    import torch

    from repro_torch.kernels import common, cuda
    from repro_torch.kernels.gaussian import ops
    from repro_torch.utils import prng

    m, n = SHAPES["fig4a"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    key = prng.worker_key(prng.prng_key(seed), 1)
    X = torch.randn((n, 50), generator=g, device="cuda")
    _, S = ops.gaussian_sketch_keep(key, X, m)
    Y = torch.randn((m, 1), generator=g, device="cuda")
    out = torch.empty((n, 1), device="cuda")
    lib = cuda._library("adjoint")
    ns, rows = cuda.plan_adjoint(m, n, 1)
    dev = Y.device
    stream = torch.cuda.current_stream().cuda_stream
    sp, yp, op = S.data_ptr(), Y.data_ptr(), out.data_ptr()
    counter = ops.LAUNCHES.__class__()

    def device_context():
        with torch.cuda.device(dev):
            pass

    def fp32_matmul():
        with common.full_fp32_matmul():
            return torch.matmul(S[:, :n].T, Y)

    pieces = {
        "torch_empty": lambda: torch.empty((n, 1), dtype=torch.float32, device=dev),
        "new_empty": lambda: Y.new_empty((n, 1)),
        "device_context": device_context,
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "checks": lambda: cuda._check_kept(S, dev.index, m, n),
        "plan": lambda: cuda.plan_adjoint(m, n, 1),
        "ctypes_launch": lambda: lib.repro_adjoint_kept(sp, S.shape[1], yp, m, 1, n, rows, ns, op, 0, stream),
        "wrapper": lambda: cuda.gaussian_adjoint_kept(S, Y, n, launches=counter, name="kept"),
        "ops_call": lambda: ops.gaussian_adjoint_kept(S, Y, n),
        "redraw_ops_call": lambda: ops.gaussian_adjoint(key, Y, n),
        "library": lambda: torch.matmul(S[:, :n].T, Y),
        "library_in_fp32_context": fp32_matmul,
        "sketch": lambda: ops.gaussian_sketch(key, X, m),
        "sketch_keep": lambda: ops.gaussian_sketch_keep(key, X, m),
        "kept_s_empty": lambda: torch.empty((m, cuda.kept_sketch_ld(n)), dtype=torch.float32, device=dev),
    }
    if state == "after_sync_debug":
        torch.cuda.set_sync_debug_mode("error")
        torch.cuda.set_sync_debug_mode("default")
    if state == "after_profiler":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for f in pieces.values():
                f()
            torch.cuda.synchronize()
    host = {k: host_us(f) for k, f in pieces.items()}
    events = {k: event_ms(pieces[k], 200) for k in ("ctypes_launch", "wrapper", "ops_call", "redraw_ops_call",
                                                    "library", "library_in_fp32_context", "sketch", "sketch_keep")}
    return {"shape": f"fig4a_host_{state}", "m": m, "n": n, "k": 1, "host_us": host, "event_ms": events}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shapes", default=",".join(SHAPES))
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--splits", default="8,16,32,64")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--out", default=str(ROOT / "build" / "adjoint_tune.jsonl"))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("adjoint_tune: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    names = args.variants.split(",")
    t0 = time.perf_counter()
    built = build(names, ROOT / "build" / "adjoint_tune")
    lines = [{"build_seconds": time.perf_counter() - t0, "ptxas": built["ptxas"], "card": smi}]
    print(json.dumps(lines[-1]), flush=True)
    splits = [int(s) for s in args.splits.split(",") if s]
    for i, tag in enumerate(args.shapes.split(",")):
        m, n = SHAPES[tag]
        lines.append(shape_rows(tag, m, n, built["libs"], splits, args.reps, 100 + i))
        print(json.dumps({k: v for k, v in lines[-1].items() if k != "runs"}), flush=True)
        torch.cuda.empty_cache()
    for state in ("fresh", "after_sync_debug", "after_profiler"):
        lines.append(host_costs(200, state))
        print(json.dumps(lines[-1]), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
