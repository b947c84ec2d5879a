#!/usr/bin/env python3
"""``chip_smoke.py``'s training phases alone: the quick way to rerun them on a card.

Run from the root of a checkout, on a machine with one CUDA card and ``nvcc``:

    python3 tools/train_phases.py [--phases train,sharding]

``--phases sharding`` runs ``phase_sharding`` (``elastic_restore_card``,
``dryrun_card_check``) instead of, or beside, ``phase_train``.

Builds the kernels (``phase_build``), then runs ``phase_train``
(``train_granite_sketch_dp``, ``train_granite_row12b``,
``train_mixtral_sketch_dp``, ``train_mixtral_row12b``,
``train_small_card_vs_cpu``) with the smoke's settings: TF32 off, bf16 products
reduced in float32, ``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS starts. Prints
the card's name and power limit, the phases' JSON lines, and exits non-zero
when a check fails (about 3 minutes on an H100).
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="train", help="comma-separated: train, sharding")
    phases = ap.parse_args().phases.split(",")

    if not torch.cuda.is_available():
        print("train_phases: CUDA is not available; this script runs on the GPU only", file=sys.stderr)
        return 2
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(cs.nvidia_smi_line(), flush=True)
    cs.emit({"total_memory": torch.cuda.get_device_properties(0).total_memory})
    cs.phase_build()
    rows = {"sjlt_apply_long": {}, "gaussian_sketch": {}, "gaussian_adjoint": {}}
    try:
        if "train" in phases:
            cs.phase_train(rows)
        if "sharding" in phases:
            cs.phase_sharding(rows)
    except cs.SmokeFailure as exc:
        print(f"train_phases: FAILED: {exc}", file=sys.stderr)
        return 1
    cs.emit({"rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
