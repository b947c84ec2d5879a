#!/usr/bin/env python3
"""``chip_smoke.py``'s decoder-family phases alone: the quick way to rerun them on a card.

Run from the root of a checkout, on a machine with one CUDA card and ``nvcc``:

    python3 tools/lm_phases.py

Builds the kernels (``phase_build``: head fitting on gemma3-12b's features runs
rows 2 and 11), then runs ``phase_lm_families`` (chatglm3-6b; mixtral-8x7b at 8
layers; gemma3-12b whole with its head fitting and launcher; grok-1-314b at 2
layers) with the smoke's settings: TF32 off, bf16 products reduced in float32.
Prints the card's name and power limit, the phases' JSON lines, and exits
non-zero when a check fails (about 4 minutes on an H100).
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("lm_phases: CUDA is not available; this script runs on the GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(cs.nvidia_smi_line(), flush=True)
    cs.phase_build()
    rows = {"gaussian_gram_multi": {}, "sjlt_gram_multi": {}}
    try:
        cs.phase_lm_families(rows)
    except cs.SmokeFailure as exc:
        print(f"lm_phases: FAILED: {exc}", file=sys.stderr)
        return 1
    cs.emit({"rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
