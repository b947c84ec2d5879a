#!/usr/bin/env python3
"""``chip_smoke.py``'s decoder-family phases alone: the quick way to rerun them on a card.

Run from the root of a checkout, on a machine with one CUDA card and ``nvcc``:

    python3 tools/lm_phases.py [--phases families,mla_hybrid,encdec_vlm,ssm]

Builds the kernels (``phase_build``: head fitting on gemma3-12b's,
hymba-1.5b's and pixtral-12b's features runs rows 2 and 11), then runs the
phases named, by default all four: ``families`` is ``phase_lm_families``
(chatglm3-6b; mixtral-8x7b, gemma3-12b and grok-1-314b at the smoke's depths,
gemma3 with its head fitting, and whole through its launcher),
``mla_hybrid`` is ``phase_lm_mla_hybrid`` (minicpm3-4b, and hymba-1.5b with
its head fitting, each whole), ``encdec_vlm`` is ``phase_lm_encdec_vlm``
(whisper-small whole, also through its launcher, and pixtral-12b at the
smoke's depth with its head fitting), ``ssm`` is ``phase_lm_ssm``
(falcon-mamba-7b whole in bfloat16 and in float32, also through its
launcher), with the smoke's settings: TF32 off,
bf16 products reduced in float32. Prints the card's name and power limit, the phases' JSON
lines, and exits non-zero when a check fails.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    import chip_smoke as cs

    phases = {"families": cs.phase_lm_families, "mla_hybrid": cs.phase_lm_mla_hybrid,
              "encdec_vlm": cs.phase_lm_encdec_vlm, "ssm": cs.phase_lm_ssm}
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(phases), help="comma-separated, of: " + ", ".join(phases))
    names = ap.parse_args().phases.split(",")
    unknown = [n for n in names if n not in phases]
    if unknown:
        ap.error(f"unknown phases {unknown}")
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
        for name in names:
            phases[name](rows)
    except cs.SmokeFailure as exc:
        print(f"lm_phases: FAILED: {exc}", file=sys.stderr)
        return 1
    cs.emit({"rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
