#!/usr/bin/env python3
"""Time the FWHT kernels (``src/repro_torch/csrc/fwht.cu``: the full transform
``repro_fwht`` and the fused SRHT forward ``repro_srht_forward``) beside an
earlier commit's ``fwht.cu``, patched copies of it and the compositions the SRHT
forward replaced, at the SRHT's path shapes; or time a checkout's SRHT forward
wrapper whole.

Run from the root of a checkout, on a machine with one CUDA card and ``nvcc``:

    python3 tools/fwht_tune.py [--parent build/parent/src/repro_torch/csrc/fwht.cu]
                               [--extra NAME=copy.cu ...] [--shapes fig3a,hybrid,fig4a,fig4a_hybrid]
                               [--reps 5] [--out PATH]
    python3 tools/fwht_tune.py --wrapper-only [--src OTHER_CHECKOUT/src] [--shapes ...] [--out PATH]

"port" is ``fwht.cu`` as the port builds it. ``--parent`` builds an earlier
``fwht.cu`` whose ``repro_fwht`` took its plan as an int array (commit
``10cd60f`` and before; unpack that commit with ``git archive`` under
``build/``). ``--extra NAME=PATH`` builds a patched copy of ``fwht.cu`` with
the port's C entries and times it as NAME beside the port. At each shape (n
data rows, k columns, m sampled rows, the SRHT's n_pad = next_pow2(n)), on the
same A and the same worker's diagonal and row ids, it times with CUDA events
(``CALLS`` calls in a row, the labels interleaved, the median of ``--reps``
rounds kept):

* ``<name>/fwht`` and ``parent/fwht``: H·x of A zero-padded to n_pad rows
  (outputs and scratch allocated once, the C entry alone);
* ``<name>/forward``: the fused forward into a preallocated output, the ids
  already on the card;
* ``.../rev``: the same on ``plan_fwht``'s passes smaller first (9, 10 for 2^19);
* ``port/composed`` and ``parent/composed``: what ``SRHTOp.apply`` ran before
  the fused forward, with that build's FWHT: torch's D·A (the diagonal drawn on
  the card), the zero rows, the transform, the gather times 1/√m, and the ids'
  copy to the card;
* ``passes_ms``: each build's calls' device time by pass (``torch.profiler``);
* ``ops``: the port's wrapper ``fwht.ops.srht_forward`` whole (checks, the ids'
  pinned copy, allocations) and ``plain``: ``fwht.ref.srht_forward``.

Every build's outputs are checked bitwise against the plain versions (and the
parent's FWHT too). ``bound_ms``: A and the ids read once and the output written
once at 3.35 TB/s; ``floor_ms``: the fused plan's bytes (A once, each
intermediate written and read once, m rows); ``fwht_floor_ms``: one read and one
write of n_pad rows a pass of ``plan_fwht``.

``host_us`` (at FIG4A's forward, 1,000 × 50, m = 200, and the hybrid's 2^15 ×
251, m = 2,500, where a call is host-bound): host microseconds a call, over
3,000 calls in a row, of each piece of the wrapper ``cuda.srht_forward`` and of
the whole ``ops.srht_forward``, with ``event_ms`` the same calls' event time.

``--wrapper-only`` times nothing but ``fwht.ops.srht_forward`` whole, as a
caller sees it, at each shape: ``event_ms`` (``CALLS`` calls in a row, median
of ``--reps``), ``host_us`` (3,000 calls) and ``device_ms`` (its kernels'
device time a call, ``torch.profiler``), bitwise against the plain version.
``--src`` imports ``repro_torch`` from another checkout's ``src`` (which builds
its kernels under its own root), so two versions of the wrapper can be timed,
each in a fresh process, in one session on the card.

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

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

SHAPES = {"fig3a": (500_000, 251, 2500), "hybrid": (25_000, 251, 2500), "fig4a": (1000, 50, 200),
          "fig4a_hybrid": (500, 50, 200)}  # (n, k, m)
CALLS = 20
PEAK_BYTES = 3.35e12


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


def pass_ms(fn, calls: int = 10) -> dict:
    """Device ms a call of each kernel ``fn`` launches (a pass: ``fwht_pass_kernel<t, mode>``),
    under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return out


def build(parent: str | None, extras: list[str], out_dir: Path) -> dict:
    """The port's library, the parent's and each extra's (all nvcc at once),
    bound, with their registers and spills."""
    from repro_torch.kernels import cuda

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda.nvcc_path()
    sources = {"port": None, "parent": parent, **dict(e.split("=", 1) for e in extras)}
    procs = {}
    for name, src in sources.items():
        if name != "port" and not src:
            continue
        cmd = cuda.nvcc_command(nvcc, "fwht", out_dir / f"libfwht_{name}.so")
        if src:
            cmd[-1] = str(Path(src).resolve())
            cmd[cmd.index("-I") + 1] = str(cuda.CSRC)
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    P, I, LL, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_uint
    libs, usage = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"libfwht_{name}.so"))
        if name == "parent":
            lib.repro_fwht.argtypes = [P, P, LL, I, ctypes.POINTER(I), I, P]
        else:
            lib.repro_fwht.argtypes = [P, P, LL, I, LL, I, I, P]
            lib.repro_srht_forward.argtypes = [P, LL, I, U, U, P, I, F, P, P, LL, LL, LL, I, I, P]
            lib.repro_srht_forward.restype = I
        lib.repro_fwht.restype = I
        libs[name] = lib
        usage[name] = [r for r in cuda.ptxas_usage(log) if r.get("spill_stores") or "<10" in r["kernel"]]
    return {"libs": libs, "ptxas": usage}


def shape_rows(tag: str, n: int, k: int, m: int, libs: dict, reps: int, seed: int) -> dict:
    import torch

    from repro_torch.core import operators, sketches as sk
    from repro_torch.kernels import common, cuda
    from repro_torch.kernels.fwht import ops, ref
    from repro_torch.utils import prng

    n_pad = sk.next_pow2(n)
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn((n, k), generator=g, device="cuda")
    x = torch.zeros((n_pad, k), device="cuda")
    x[:n] = A
    kd, ids = operators.srht_params(prng.worker_key(prng.prng_key(seed), 0), m, n_pad)
    kd0, kd1 = common.key_words(kd)
    ids_dev = ids.to(dev, torch.int32)
    scale = common.inv_sqrt(m)
    want_fwd = ref.srht_forward(kd0, kd1, ids, A, n_pad)
    want_h = ref.fwht(x)
    plan = cuda.plan_fwht(n_pad)
    packed, passes = cuda._packed_fwht_plan(n_pad)
    parent_bits = (ctypes.c_int * len(plan))(*plan)
    ld = common.round_up(k, cuda.FWHT_SCRATCH_ALIGN)
    scratch = torch.empty((n_pad, ld), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    calls, bitwise = {}, {}

    rev = tuple(sorted(plan))
    orders = {"": (packed, passes)}
    if rev != tuple(plan):
        orders["/rev"] = (sum(t << (4 * p) for p, t in enumerate(rev)), len(rev))

    def composed(run_fwht, dst):
        def call():
            DA = A * ref.diagonal(kd0, kd1, torch.arange(n, device=dev))[:, None]
            if n_pad != n:
                DA = torch.cat([DA, DA.new_zeros((n_pad - n, k))])
            if run_fwht(DA.data_ptr(), dst.data_ptr()):
                raise RuntimeError("fwht refused")
            return dst[ids.to(dev)] * scale
        return call

    def record(label, call, out, want):
        if call():
            raise RuntimeError(f"{label} refused ({n}, {k}, {m})")
        bitwise[label] = bool(torch.equal(out, want))
        calls[label] = call

    for name, lib in libs.items():
        y = torch.empty_like(x)
        if name == "parent":
            raw = lambda s, d, lib=lib: lib.repro_fwht(s, d, n_pad, k, parent_bits, len(plan), stream)
            record("parent/fwht", lambda raw=raw, y=y: raw(x.data_ptr(), y.data_ptr()), y, want_h)
        else:
            raw = lambda s, d, lib=lib: lib.repro_fwht(s, d, n_pad, k, packed, passes, 0, stream)
            for order, (pk, ps) in orders.items():
                y = torch.empty_like(x)
                record(f"{name}/fwht{order}", lambda lib=lib, y=y, pk=pk, ps=ps: lib.repro_fwht(
                    x.data_ptr(), y.data_ptr(), n_pad, k, pk, ps, 0, stream), y, want_h)
                out = torch.empty((m, k), device="cuda")
                record(f"{name}/forward{order}", lambda lib=lib, out=out, pk=pk, ps=ps:
                       lib.repro_srht_forward(A.data_ptr(), n, k, kd0, kd1, ids_dev.data_ptr(), m, scale,
                                              out.data_ptr(), scratch.data_ptr(), ld, n_pad, pk, ps, 0, stream),
                       out, want_fwd)
        if name in ("parent", "port"):
            comp = composed(raw, torch.empty_like(x))
            bitwise[f"{name}/composed"] = bool(torch.equal(comp(), want_fwd))
            calls[f"{name}/composed"] = comp
    calls["ops"] = lambda: ops.srht_forward(kd0, kd1, ids, A, n_pad)
    bitwise["ops"] = bool(torch.equal(calls["ops"](), want_fwd))
    calls["plain"] = lambda: ref.srht_forward(kd0, kd1, ids, A, n_pad)
    passes_ms = {label: pass_ms(calls[label]) for label in calls
                 if "/" in label and "composed" not in label and not label.startswith("parent")}
    times: dict = {}
    del y
    order = list(calls)
    for r in range(reps):
        for label in order[r % len(order):] + order[: r % len(order)]:
            times.setdefault(label, []).append(event_ms(calls[label], 3 if label == "plain" else CALLS))
    med = {label: statistics.median(v) for label, v in times.items()}
    inter, done = 0, 0
    for t in plan[:-1]:
        done += t
        inter += -(-n // (1 << done)) * (1 << done)
    return {"shape": tag, "n": n, "k": k, "m": m, "n_pad": n_pad, "plan": list(plan),
            "bound_ms": 4 * (n * k + m + m * k) / PEAK_BYTES * 1e3,
            "floor_ms": 4 * (n * k + 2 * inter * k + m + m * k) / PEAK_BYTES * 1e3,
            "fwht_floor_ms": 8 * n_pad * k * len(plan) / PEAK_BYTES * 1e3,
            "fwht_bound_ms": 8 * n_pad * k / PEAK_BYTES * 1e3,
            "ms": med, "passes_ms": passes_ms, "bitwise": bitwise, "runs": times}


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


def host_costs(tag: str, seed: int) -> dict:
    """Host microseconds a call of each piece of ``cuda.srht_forward`` at the
    shape ``tag``, and of the whole wrapper."""
    import torch

    from repro_torch.core import operators
    from repro_torch.kernels import common, cuda
    from repro_torch.kernels.fwht import ops
    from repro_torch.utils import prng

    n, k, m = SHAPES[tag]
    n_pad = 1 << (n - 1).bit_length()
    A = torch.randn((n, k), generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    kd, ids = operators.srht_params(prng.worker_key(prng.prng_key(seed), 0), m, n_pad)
    kd0, kd1 = common.key_words(kd)
    lib = cuda._library("fwht")
    packed, passes = cuda._packed_fwht_plan(n_pad)
    ids_dev = ids.to("cuda", torch.int32)
    out = torch.empty((m, k), device="cuda")
    ld = common.round_up(k, cuda.FWHT_SCRATCH_ALIGN)
    scratch = torch.empty((n_pad, ld), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    counter = ops.LAUNCHES.__class__()
    staged = torch.empty(m, dtype=torch.int32, pin_memory=True)
    pieces = {
        "checks": lambda: (A.is_cuda, A.dtype, A.ndim, A.is_contiguous(), ids.device.type, ids.ndim, ids.dtype),
        "range_check": lambda: ids.numpy().view(np.uint64).max() >= n_pad,
        "pinned_empty": lambda: torch.empty(m, dtype=torch.int32, pin_memory=True),
        "ids_stage": lambda: staged.numpy().__setitem__(slice(None), ids.numpy()),
        "ids_copy": lambda: staged.to(A.device, non_blocking=True),
        "get_device": lambda: A.get_device(),
        "inv_sqrt": lambda: common.inv_sqrt(m),
        "new_empty": lambda: A.new_empty((m, k)),
        "plan": lambda: cuda._packed_fwht_plan(n_pad),
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "ctypes_launch": lambda: lib.repro_srht_forward(A.data_ptr(), n, k, kd0, kd1, ids_dev.data_ptr(), m,
                                                       common.inv_sqrt(m), out.data_ptr(), scratch.data_ptr(), ld,
                                                       n_pad, packed, passes, 0, stream),
        "wrapper": lambda: cuda.srht_forward(kd0, kd1, ids, A, n_pad, launches=counter, name="f"),
        "ops_call": lambda: ops.srht_forward(kd0, kd1, ids, A, n_pad),
    }
    host = {key: host_us(f) for key, f in pieces.items()}
    events = {key: event_ms(pieces[key], 200) for key in ("ctypes_launch", "wrapper", "ops_call")}
    return {"shape": f"{tag}_host", "n": n, "k": k, "m": m, "host_us": host, "event_ms": events}


def wrapper_only(tag: str, reps: int, seed: int) -> dict:
    """``fwht.ops.srht_forward`` whole at the shape ``tag``, from whichever
    ``repro_torch`` is imported: event ms a call over ``CALLS`` calls in a row
    (median of ``reps``), host µs a call, its kernels' device ms a call."""
    import torch

    from repro_torch.core import operators
    from repro_torch.kernels import common
    from repro_torch.kernels.fwht import ops, ref
    from repro_torch.utils import prng

    n, k, m = SHAPES[tag]
    n_pad = 1 << (n - 1).bit_length()
    A = torch.randn((n, k), generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    kd, ids = operators.srht_params(prng.worker_key(prng.prng_key(seed), 0), m, n_pad)
    kd0, kd1 = common.key_words(kd)
    call = lambda: ops.srht_forward(kd0, kd1, ids, A, n_pad)
    bitwise = bool(torch.equal(call(), ref.srht_forward(kd0, kd1, ids, A, n_pad)))
    events = [event_ms(call) for _ in range(reps)]
    device = sum(pass_ms(call).values())
    return {"shape": f"{tag}_wrapper", "src": ops.__file__, "n": n, "k": k, "m": m,
            "event_ms": statistics.median(events), "event_runs": events, "host_us": host_us(call),
            "device_ms": device, "bitwise": bitwise}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", default=None)
    parser.add_argument("--extra", action="append", default=[])
    parser.add_argument("--wrapper-only", action="store_true")
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--shapes", default=",".join(SHAPES))
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--out", default=str(ROOT / "build" / "fwht_tune.jsonl"))
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("fwht_tune: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    lines = []
    if args.wrapper_only:
        for i, tag in enumerate(args.shapes.split(",")):
            lines.append(wrapper_only(tag, args.reps, 300 + i))
            print(json.dumps({k: v for k, v in lines[-1].items() if k != "event_runs"}), flush=True)
            if not lines[-1]["bitwise"]:
                print(f"fwht_tune: {tag}: the wrapper is not bitwise its plain version", file=sys.stderr)
                return 1
    else:
        t0 = time.perf_counter()
        built = build(args.parent, args.extra, ROOT / "build" / "fwht_tune")
        lines.append({"build_seconds": time.perf_counter() - t0, "ptxas": built["ptxas"], "card": smi})
        print(json.dumps(lines[-1]), flush=True)
        for i, tag in enumerate(args.shapes.split(",")):
            lines.append(shape_rows(tag, *SHAPES[tag], built["libs"], args.reps, 300 + i))
            print(json.dumps({k: v for k, v in lines[-1].items() if k != "runs"}), flush=True)
            if not all(lines[-1]["bitwise"].values()):
                print(f"fwht_tune: {tag}: not bitwise {lines[-1]['bitwise']}", file=sys.stderr)
                return 1
            torch.cuda.empty_cache()
        for tag in ("fig4a", "hybrid"):
            lines.append(host_costs(tag, 400))
            print(json.dumps(lines[-1]), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
