"""Hardware figures of the port's target: the NVIDIA H100 SXM.

Port of ``repro.roofline.hw`` with the card's own figures; no TPU figure is
carried over. Compute, memory and NVLink come from NVIDIA's H100 data sheet
(SXM, dense, 700 W); ``hbm_bytes`` is what
``torch.cuda.get_device_properties(0).total_memory`` reports on an H100 80GB
HBM3. A field keeps the reference's name where its meaning holds:
``ici_link_bw`` is a card's NVLink bandwidth each way inside a host of
``host_size`` cards on NVSwitch (every card reaches every other at that rate,
so ``ici_links`` is 1), and ``dcn_bw`` a card's share of the network between
hosts. That fabric is an assumption, not a measurement: one 400 Gb/s NDR
InfiniBand link a card, 50e9 B/s each way.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops_bf16: float       # FLOP/s per card, bf16 tensor cores
    hbm_bw: float                # bytes/s per card
    ici_link_bw: float           # bytes/s per card inside a host, one direction
    ici_links: int               # links a collective's ring uses per card
    hbm_bytes: float             # capacity per card
    dcn_bw: float                # bytes/s per card between hosts, one direction
    peak_flops_tf32: float = 0.0     # FLOP/s, TF32 tensor cores
    peak_flops_fp32: float = 0.0     # FLOP/s, float32 FFMA outside the tensor cores
    peak_int32_ops: float = 0.0      # integer ops/s
    host_size: int = 1               # cards a host joins by ici_link_bw


H100_SXM = HwSpec(
    name="nvidia_h100_sxm",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    ici_link_bw=450e9,
    ici_links=1,
    hbm_bytes=85_017_493_504,
    dcn_bw=50e9,
    peak_flops_tf32=495e12,
    peak_flops_fp32=67e12,
    # INT32: 64 lanes per SM, half the 128 FP32 lanes (Hopper white paper), at the same
    # clock: 67/4 T integer ops/s counting an FFMA as 2 flops.
    peak_int32_ops=16.7e12,
    host_size=8,
)
