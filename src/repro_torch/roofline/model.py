"""Three-term roofline of a dry-run cell on the H100's figures.

Port of ``repro.roofline.model``:

    compute    = flops_per_device / peak bf16 FLOP/s
    memory     = bytes_per_device / HBM bandwidth
    collective = Σ wire_bytes(op) / link bandwidth   (NVLink inside a host,
                                                      the network across hosts)

The dry run counts flops and bytes per device on each rank's local ops
(``launch.dryrun``), so no division by the card count is needed. MODEL_FLOPS =
6·N·D (training) / 2·N·D (inference) with N = active params — the "useful work"
yardstick; MODEL_FLOPS / (flops_per_device · cards) exposes remat and redundant
compute. :func:`roofline_terms` takes the recorded collectives
(``roofline.collectives``), aggregated by kind, where the reference took HLO
text; the dry run's records come from it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.roofline import collectives as C
from repro_torch.roofline.hw import H100_SXM, HwSpec


@dataclasses.dataclass
class RooflineResult:
    arch: str
    shape: str
    mesh: str
    chips: int
    # raw
    flops_per_device: float
    bytes_per_device: float
    collective: Dict[str, float]
    # terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    # derived
    bottleneck: str
    step_s: float                  # max of the three (perfect-overlap lower bound)
    model_flops: float             # 6·N·D or 2·N·D, global
    useful_fraction: float         # model_flops / (flops_per_device · chips)
    roofline_fraction: float       # compute_s / step_s  (1.0 = compute-bound at peak)

    def table_row(self) -> str:
        return (
            f"| {self.arch} | {self.shape} | {self.mesh} | "
            f"{self.compute_s*1e3:.2f} | {self.memory_s*1e3:.2f} | {self.collective_s*1e3:.2f} | "
            f"{self.bottleneck} | {self.useful_fraction:.2f} | {self.roofline_fraction:.2f} |"
        )


def roofline_terms(
    *,
    arch: str,
    shape: str,
    mesh: str,
    chips: int,
    cost: Dict[str, float],
    collectives: Dict[str, Dict[str, float]],
    model_flops: float,
    hw: HwSpec = H100_SXM,
) -> RooflineResult:
    """``cost``: {"flops", "bytes accessed"} per device; ``collectives``: the
    per-kind aggregate of the recorded ops (``C.summarize_collectives``, or its
    depth extrapolation), costed by ``C.collective_seconds``."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    coll = C.collective_seconds(collectives, ici_bw=hw.ici_link_bw, dcn_bw=hw.dcn_bw)
    compute_s = flops / hw.peak_flops_bf16
    memory_s = nbytes / hw.hbm_bw
    by = {"compute": compute_s, "memory": memory_s, "collective": coll["total_s"]}
    bottleneck = max(by, key=by.get)
    step_s = max(by.values())
    return RooflineResult(
        arch=arch, shape=shape, mesh=mesh, chips=chips, flops_per_device=flops, bytes_per_device=nbytes,
        collective=coll, compute_s=compute_s, memory_s=memory_s, collective_s=coll["total_s"],
        bottleneck=bottleneck, step_s=step_s, model_flops=model_flops,
        useful_fraction=model_flops / max(flops * chips, 1.0),
        roofline_fraction=compute_s / step_s if step_s > 0 else 0.0,
    )


def extrapolate(v1: float, v2: float, L1: int, L2: int, L: int) -> float:
    """Linear-in-depth extrapolation: total(L) = f(L1) + slope·(L-L1)."""
    per = (v2 - v1) / (L2 - L1)
    return max(v1 + per * (L - L1), 0.0)


def extrapolate_cell(cost1, cost2, agg1, agg2, L1, L2, L):
    """Extrapolate a cost dict + per-kind collective aggregate in depth."""
    cost = {
        k: extrapolate(float(cost1.get(k, 0.0)), float(cost2.get(k, 0.0)), L1, L2, L)
        for k in set(cost1) | set(cost2)
        if isinstance(cost1.get(k, 0.0), (int, float)) and "{" not in k
    }
    kinds = set(agg1) | set(agg2)
    agg = {}
    for kind in kinds:
        z = {"count": 0.0, "bytes": 0.0, "wire_bytes": 0.0, "dcn_wire_bytes": 0.0}
        a1, a2 = agg1.get(kind, z), agg2.get(kind, z)
        agg[kind] = {f: extrapolate(a1[f], a2[f], L1, L2, L) for f in z}
    return cost, agg


def model_flops_for(cfg, shape, *, mode: str) -> float:
    """6·N_active·D for train, 2·N_active·D for inference (D = tokens processed)."""
    n_active = cfg.active_param_count()
    if mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch
