"""Record the collectives a DTensor program issues, and cost them.

A change of method from ``repro.roofline.collectives``, not a port of it. The
reference parses the collectives out of XLA's post-SPMD HLO text
(``parse_collectives``); the port has no HLO, so that parser has no
counterpart. Here the dry run's dispatch mode (``launch.dryrun.StepCounter``)
sees each ``_c10d_functional`` op that DTensor issues on the local shards
(``CommDebugMode`` counts them but keeps no bytes) and :func:`record` keeps:

    kind          all-gather, all-reduce, reduce-scatter, all-to-all
    bytes         the local buffer the ring factor multiplies: an all-gather's
                  gathered output, a reduce-scatter's input, an all-reduce's
                  tensor, an all-to-all's input
    group_size    the ranks of the op's process group
    crosses_host  whether those ranks span more than one host of ``host_size``

and keeps the reference's ring-algorithm accounting (:func:`op_wire_bytes`),
its per-kind aggregate (:func:`summarize_collectives`) and the time its dry run
gives that aggregate (:func:`collective_seconds`): NVLink inside a host, the
network between hosts.

    all-gather        (P-1)/P · out_bytes          per device
    reduce-scatter    (P-1)/P · in_bytes           per device
    all-reduce        2·(P-1)/P · bytes            (RS + AG)
    all-to-all        (P-1)/P · bytes
    collective-permute  bytes                      (one hop)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    bytes: int            # per-device buffer bytes (see the module's docstring)
    group_size: int
    crosses_host: bool


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_ranks(group) -> list:
    """The global ranks of a process group, given as the group or its name."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    if isinstance(group, str):
        group = c10d._resolve_process_group(group)
    return dist.get_process_group_ranks(group)


def _ops() -> dict:
    """``_c10d_functional`` op → (kind, which buffer counts: "in" or "out")."""
    f = torch.ops._c10d_functional
    table = {
        f.all_gather_into_tensor.default: ("all-gather", "out"),
        f.reduce_scatter_tensor.default: ("reduce-scatter", "in"),
        f.all_reduce.default: ("all-reduce", "in"),
        f.all_to_all_single.default: ("all-to-all", "in"),
    }
    for name, kind in (("all_gather_into_tensor", ("all-gather", "out")),
                       ("reduce_scatter_tensor", ("reduce-scatter", "in")),
                       ("all_to_all_single", ("all-to-all", "in"))):
        try:  # the autograd-aware twins, where this torch has them
            table[getattr(torch.ops._c10d_functional_autograd, name).default] = kind
        except (AttributeError, RuntimeError):
            pass
    return table


_TABLE: Optional[dict] = None


def record(func, args, kwargs, out, host_size: int) -> Optional[CollectiveOp]:
    """The record of one dispatched op, or None when it is no collective."""
    global _TABLE
    if _TABLE is None:
        _TABLE = _ops()
    entry = _TABLE.get(func)
    if entry is None:
        return None
    kind, which = entry
    group = kwargs["group_name"] if "group_name" in kwargs else args[-1]
    ranks = _group_ranks(group)
    buf = out if which == "out" else args[0]
    return CollectiveOp(kind, _nbytes(buf), len(ranks), len({r // host_size for r in ranks}) > 1)


def is_collective(func) -> bool:
    return getattr(func, "namespace", "") in ("_c10d_functional", "_c10d_functional_autograd")


def op_wire_bytes(op: CollectiveOp) -> float:
    """Per-device bytes that actually traverse links (ring-algorithm accounting)."""
    p = max(op.group_size, 1)
    frac = (p - 1) / p if p > 1 else 0.0
    if op.kind == "all-reduce":
        return 2.0 * frac * op.bytes
    if op.kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return frac * op.bytes
    return float(op.bytes)


def summarize_collectives(ops: List[CollectiveOp]) -> Dict[str, Dict[str, float]]:
    """Count, bytes, wire bytes and the wire bytes that cross a host, per kind."""
    agg: Dict[str, Dict[str, float]] = {}
    for op in ops:
        e = agg.setdefault(op.kind, {"count": 0.0, "bytes": 0.0, "wire_bytes": 0.0, "dcn_wire_bytes": 0.0})
        wb = op_wire_bytes(op)
        e["count"] += 1
        e["bytes"] += op.bytes
        e["wire_bytes"] += wb
        if op.crosses_host:
            e["dcn_wire_bytes"] += wb
    return agg


def collective_seconds(agg: Dict[str, Dict[str, float]], *, ici_bw: float, dcn_bw: float) -> Dict[str, float]:
    """Wire time per device of a per-kind aggregate (:func:`summarize_collectives`,
    or its depth extrapolation): the wire bytes inside a host at ``ici_bw``,
    those crossing a host at ``dcn_bw``. The reference dry run's costing."""
    total_s = dcn_s = wire = 0.0
    for e in agg.values():
        ici_bytes = e["wire_bytes"] - e["dcn_wire_bytes"]
        total_s += ici_bytes / ici_bw + e["dcn_wire_bytes"] / dcn_bw
        dcn_s += e["dcn_wire_bytes"] / dcn_bw
        wire += e["wire_bytes"]
    return {"total_s": total_s, "dcn_s": dcn_s, "wire_bytes": wire}
