"""Render the dry run's JSON records into the dry-run and roofline tables.

Port of ``repro.roofline.report`` over the port's records (``launch.dryrun``):
every figure is predicted from data-sheet figures (``roofline.hw.H100_SXM``),
none is measured.

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

GB = 1e9


def load(dir_: str) -> List[Dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def _fmt_terms(r) -> str:
    rl = r["roofline"]
    return f"{rl['compute_s']*1e3:9.1f} | {rl['memory_s']*1e3:9.1f} | {rl['collective_s']*1e3:9.1f}"


def dryrun_table(recs: List[Dict], mesh: str) -> str:
    lines = [
        "| arch | shape | status | run_s | args GB | temp GB | fits H100 | collective schedule (count×kind) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        if r["status"] != "OK":
            reason = r.get("reason", r.get("error", ""))[:60]
            lines.append(f"| {r['arch']} | {r['shape']} | {r['status']} | — | — | — | — | {reason} |")
            continue
        m = r["memory"]
        sched = ", ".join(
            f"{int(round(v['count']))}×{k}" for k, v in sorted(r["collectives"].items())
        ) or "none"
        lines.append(
            f"| {r['arch']} | {r['shape']} | OK | {r['run_s']} | "
            f"{m['argument_bytes']/GB:.2f} | {m['temp_bytes']/GB:.2f} | "
            f"{'✓' if r['fits_hbm'] else '✗'} | {sched} |"
        )
    return "\n".join(lines)


def roofline_table(recs: List[Dict], mesh: str) -> str:
    lines = [
        "| arch | shape | compute ms | memory ms | collective ms | bottleneck | MODEL_FLOPS | useful frac | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != mesh or r["status"] != "OK":
            continue
        rl = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_terms(r)} | {rl['bottleneck']} | "
            f"{rl['model_flops']:.2e} | {rl['useful_fraction']:.2f} | {rl['roofline_fraction']:.3f} |"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    default_dir = os.path.normpath(
        os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch")
    )
    ap.add_argument("--dir", default=default_dir)
    args = ap.parse_args(argv)
    recs = load(args.dir)
    for mesh in ("pod16x16", "pod2x16x16"):
        if not any(r["mesh"] == mesh for r in recs):
            continue
        print(f"\n### Dry run — {mesh} (predicted from data-sheet figures, NVIDIA H100 SXM, 700 W)\n")
        print(dryrun_table(recs, mesh))
        print(f"\n### Roofline — {mesh} (predicted from data-sheet figures, NVIDIA H100 SXM, 700 W)\n")
        print(roofline_table(recs, mesh))
    n_ok = sum(r["status"] == "OK" for r in recs)
    n_fit = sum(r.get("fits_hbm", False) for r in recs)
    print(f"\n{n_ok} OK cells, {n_fit} fit the H100's memory, "
          f"{sum(r['status'] == 'SKIP' for r in recs)} skips, {sum(r['status'] == 'FAIL' for r in recs)} fails")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
