#!/usr/bin/env python3
"""Device time of row 12b (the SJLT S·A of few, long columns) by kernel.

Run from the root of a checkout, on a machine with one CUDA card and ``nvcc``:

    python3 tools/sjlt_long_profile.py [--log2-d 20,24,28] [--ratio 0.1] [--reps 5]

For a CountSketch (s = 1) of one N(0, 1) vector of D = 2^k coordinates at
m = ceil(ratio·D) sketch rows (gradient compression's shape), it times
``ops.sjlt_apply`` with CUDA events (the mean of ``--reps`` calls after a
warm-up), then one call under ``torch.profiler`` split by kernel (the scale
pass, the fixed-point pass, the finish pass, the memset, the key copy), beside
the library's ``index_add_`` of the signed entries (float atomics) on the same
vector. Each size runs in this one process, the library's operands built
before its timing. Prints the card's name and power limit, then one JSON line
a size.
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


def by_kernel_ms(fn) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0][:60]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--log2-d", default="20,24,28")
    parser.add_argument("--ratio", type=float, default=0.1)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("sjlt_long_profile: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import common
    from repro_torch.kernels.sjlt import ops
    from repro_torch.utils import prng

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    key = prng.prng_key(23)
    k0, k1 = common.key_words(key)
    for k in (int(v) for v in args.log2_d.split(",")):
        D = 1 << k
        m = max(1, math.ceil(args.ratio * D))
        X = torch.randn((D, 1), generator=torch.Generator(device="cuda").manual_seed(k), device="cuda")
        ms = event_ms(lambda: ops.sjlt_apply(key, X, m, 1), args.reps)
        kernels = by_kernel_ms(lambda: ops.sjlt_apply(key, X, m, 1))
        idx = torch.empty(D, dtype=torch.int64, device="cuda")
        src = torch.empty((D, 1), device="cuda")
        for j0 in range(0, D, 1 << 22):  # the int64 threefry of 2^22 rows at a time
            j1 = min(D, j0 + (1 << 22))
            buckets, signs = common.sjlt_counter_params(k0, k1, torch.arange(j0, j1, device="cuda"), 1, m)
            idx[j0:j1], src[j0:j1] = buckets[:, 0], signs * X[j0:j1]
        lib_ms = event_ms(lambda: torch.zeros((m, 1), device="cuda").index_add_(0, idx, src), args.reps)
        del idx, src, X
        torch.cuda.empty_cache()
        print(json.dumps({"tool": "sjlt_long_profile", "card": smi, "D": D, "m": m, "ms": ms,
                          "device_ms_by_kernel": kernels, "device_ms": sum(kernels.values()),
                          "library_index_add_ms": lib_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
