#!/usr/bin/env python3
"""Host time of getting key words to the card, against a whole single-key S·A call.

Run from the root of a checkout, on a machine with one CUDA card and ``nvcc``:

    python3 tools/key_copy_cost.py [--calls 2000] [--solves 6]

Every kernel wrapper of the port copies its (q, 2) key words to the card with
``kernels/cuda.py`` ``_u32_words`` (converted on the host, then a pinned
``non_blocking`` copy, which does not wait for the card). This times, in host
microseconds a call with the card idle: that copy for one key and for 100, its
host conversion alone, the words read as Python ints (what passing one key by
value as kernel arguments would cost instead), and a whole single-key Gaussian
S·A at FIG4A's shape (X = Aᵀ, 1,000 × 50, m = 200). Then it runs FIG4A's Gaussian
least-norm solve (q = 100, one single-key S·A a worker) ``--solves`` times and
reports each solve's wall milliseconds and the milliseconds spent inside
``_u32_words``. Prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def host_us(fn, calls: int) -> float:
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=2000)
    parser.add_argument("--solves", type=int, default=6)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("key_copy_cost: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.configs.paper_lsq import FIG4A
    from repro_torch.core import distributed
    from repro_torch.core import sketches as sk
    from repro_torch.data import regression
    from repro_torch.kernels import common, cuda
    from repro_torch.kernels.gaussian import ops
    from repro_torch.utils import prng

    dev = torch.device("cuda")
    one = prng.prng_key(3).reshape(1, 2)
    many = prng.worker_keys(prng.prng_key(3), 100)
    X = torch.randn(1000, 50, device=dev)
    ops.gaussian_sketch(one[0], X, 200)  # builds and loads the library
    cpu = torch.device("cpu")
    result = {
        "u32_words_copy_q1_us": host_us(lambda: cuda._u32_words(one, dev), args.calls),
        "u32_words_copy_q100_us": host_us(lambda: cuda._u32_words(many, dev), args.calls),
        "u32_words_host_only_q1_us": host_us(lambda: cuda._u32_words(one, cpu), args.calls),
        "key_words_as_ints_q1_us": host_us(lambda: common.key_words(one[0]), args.calls),
        "gaussian_sketch_fig4a_call_us": host_us(lambda: ops.gaussian_sketch(one[0], X, 200), args.calls),
    }
    A, b, _ = regression.gaussian_regression(20270, FIG4A.n, FIG4A.d, planted=False, device=dev)
    spec = sk.SketchSpec("gaussian", FIG4A.m, use_kernel=True)
    copy = cuda._u32_words
    inside = [0.0]

    def timed_copy(words, device):
        t0 = time.perf_counter()
        out = copy(words, device)
        inside[0] += time.perf_counter() - t0
        return out

    def solve():
        return distributed.distributed_sketch_least_norm(spec, prng.prng_key(20268), A, b, q=FIG4A.q, device=dev)

    cuda._u32_words = timed_copy
    try:
        solve()
        walls, copies = [], []
        for _ in range(args.solves):
            inside[0] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            copies.append(inside[0] * 1e3)
    finally:
        cuda._u32_words = copy
    result["fig4a_gaussian_solve_ms"] = walls
    result["fig4a_gaussian_solve_key_copy_ms"] = copies
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
