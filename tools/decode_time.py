#!/usr/bin/env python3
"""The Engine's decode step time of granite-3-8b at full width, cut in depth: the
quick way to hold two trees' decode against each other on one card.

Run on a machine with one CUDA card, with ``PYTHONPATH`` naming the ``src`` of the
tree to time (this script imports only ``torch`` and that tree's ``repro_torch``):

    PYTHONPATH=src python3 tools/decode_time.py [--layers 3] [--runs 3]

Builds granite-3-8b at full width with ``--layers`` layers (bfloat16, the
reference's weights for key 0, drawn on the card), then runs greedy
``Engine.generate`` on 8 prompts of 1,536 to 2,048 tokens with 32 new tokens
(the shape of ``chip_smoke.py``'s ``LM_ENGINE``) ``--runs`` times. Each decode
step is timed on the host clock between two device synchronizations. Prints
one JSON line: the tree's ``repro_torch`` path, the card's name and power
limit, and each run's median decode ms a step (the first run warms up).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time


def main() -> int:
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.utils import prng

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_time: CUDA is not available; this script runs on the GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]

    cfg = dataclasses.replace(get_config("granite-3-8b"), num_layers=args.layers)
    model = lm.init_params(cfg, prng.prng_key(0), device="cuda")
    rs = np.random.default_rng(41)
    lens = [1536 + (i * (2048 - 1536)) // 7 for i in range(8)]
    prompts = [rs.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    new = 32
    engine = Engine(cfg, model, ServeConfig(max_batch=len(prompts), max_len=max(lens) + new), device="cuda")
    decode, steps = engine._decode, []

    def timed(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode(*a)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        return out

    engine._decode = timed
    medians = []
    for _ in range(args.runs):
        steps.clear()
        engine.generate(prompts, max_new_tokens=new)
        medians.append(statistics.median(steps))
    print(json.dumps({"tree": repro_torch.__file__, "card": card, "arch": cfg.name, "layers": cfg.num_layers,
                      "prompts": len(prompts), "new": new, "decode_ms_median_by_run": medians,
                      "decode_ms_median_warm": statistics.median(medians[1:] or medians)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
