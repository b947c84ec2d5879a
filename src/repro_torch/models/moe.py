"""Mixture-of-Experts feed-forward of the port: top-k routing with sort-based
capacity dispatch.

Port of ``repro.models.moe``. Each group's (token, expert) assignments are sorted
stably by expert id and every expert takes a window of ``capacity`` slots of its
run: gathers and products only, no (tokens, E, capacity) one-hot. The group is
one sequence (forward and prefill) or the whole batch (decode: x is (1, B, d)).
Assignments past an expert's capacity are dropped (combine weight 0; the
residual carries the token), as GShard does, and the Switch-style auxiliary
loss discourages drops.

The reference's numerics are kept: router logits are a product in x's dtype
cast to float32; the top k are taken by a stable descending sort (the lower
expert id first among equal probabilities, as ``jax.lax.top_k``); the output
starts as zeros in x's dtype and each expert's gated y is added to its kept
tokens in the order e = 0 … E−1, each add rounding in that dtype. Within one
expert the kept tokens are distinct, so an add is a gather, a sum and a
write: no float atomics. The window's slots past an expert's kept
assignments carry weight 0 in the reference; here they write to a scratch
row that is dropped, so no zero is added through a repeated index. Under
``rules`` the per-expert intermediates are constrained as the reference's
(``x_e`` and ``y`` batch-sharded, ``g`` and ``u`` also on the tensor axis);
without them ``constrain`` is the identity. The one-hot counts are a
comparison with ``arange(E)`` (the same integers as ``F.one_hot``, whose range
check has no DTensor sharding rule).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import as_dtensor, constrain, from_local, is_dtensor
from repro_torch.models import layers
from repro_torch.utils import prng


class MoE(nn.Module):
    """One MoE FFN's weights: ``router`` (d, E), ``w_gate`` and ``w_up`` (E, d, f),
    ``w_down`` (E, f, d), the reference's (in, out) orientation."""

    def __init__(self, router: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor):
        super().__init__()
        self.router, self.w_gate, self.w_up, self.w_down = (layers._param(t) for t in (router, w_gate, w_up, w_down))

    def forward(self, x: torch.Tensor, *, num_experts: int, top_k: int,
                capacity_factor: float = 1.25, rules=None) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_forward(self, x, num_experts=num_experts, top_k=top_k, capacity_factor=capacity_factor,
                           rules=rules)


def init_moe(key: torch.Tensor, d: int, f: int, num_experts: int, dtype: torch.dtype, device) -> MoE:
    """The reference's ``init_moe``: ``split(key, 4)``, each leaf one normal draw of
    its whole shape times 1/√d (router, gate, up) or 1/√f (down), drawn in
    pieces of whole rows at their flat offsets (``layers.draw_normal``)."""
    kr, kg, ku, kd = prng.split(key, 4)
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    E = num_experts
    return MoE(layers.draw_normal(kr, (d, E), s_in, dtype, device),
               layers.draw_normal(kg, (E, d, f), s_in, dtype, device),
               layers.draw_normal(ku, (E, d, f), s_in, dtype, device),
               layers.draw_normal(kd, (E, f, d), s_out, dtype, device))


# ------------------------------------------------------------------ drop counting


class DropCount:
    """Assignments routed and dropped by every ``moe_forward`` inside
    :func:`count_drops`, and each expert's assignments (``load``, (E,));
    the sums stay on the device until read."""

    def __init__(self):
        self.assigned = 0
        self.dropped: Optional[torch.Tensor] = None
        self.load: Optional[torch.Tensor] = None
        self.calls = 0

    def add(self, assigned: int, dropped: torch.Tensor, load: torch.Tensor) -> None:
        self.assigned += assigned
        self.dropped = dropped if self.dropped is None else self.dropped + dropped
        self.load = load if self.load is None else self.load + load
        self.calls += 1

    @property
    def share(self) -> float:
        """Dropped assignments over routed ones (0 when nothing was routed)."""
        return float(self.dropped) / self.assigned if self.assigned else 0.0


_COUNTER: Optional[DropCount] = None


@contextlib.contextmanager
def count_drops():
    """Count the dropped assignments and each expert's load of every MoE call in
    the block (device sums, no synchronisation): ``with count_drops() as c:
    ...; c.share``."""
    global _COUNTER
    outer, _COUNTER = _COUNTER, DropCount()
    try:
        yield _COUNTER
    finally:
        _COUNTER = outer


# ------------------------------------------------------------------ routing


def capacity(capacity_factor: float, top_k: int, tokens: int, num_experts: int) -> int:
    """Slots per expert in a group of ``tokens``: the reference's Python-float rule."""
    return min(max(1, int(capacity_factor * top_k * tokens / num_experts)), tokens * top_k)


def top_k_stable(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: the k largest values, the lower index
    first among equal values (a stable descending sort)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(ids, n)`` as a bool comparison (no range check)."""
    return ids[..., None] == torch.arange(n, device=ids.device)


def route(p: MoE, x: torch.Tensor, num_experts: int, top_k: int, rules=None):
    """x: (G, T, d) -> gate weights (G, T, k) float32, expert ids (G, T, k) int64,
    aux loss () float32 (E · Σ_e fraction of first choices · mean probability).
    Under ``rules`` the logits stay (dp, whole, whole), so that their gradient
    comes back so placed to the router product (the aux loss's mean would
    hand it back sequence-sharded)."""
    logits = constrain((x @ p.router).to(torch.float32), rules, "dp", None, None)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k_stable(probs, top_k)
    gate_vals = gate_vals / torch.clamp_min(torch.sum(gate_vals, -1, keepdim=True), 1e-9)
    T = x.shape[1]
    first = _one_hot(expert_ids[..., 0], num_experts).to(torch.float32)
    frac = torch.mean(torch.sum(first, dim=1) / T, dim=0)
    mean_prob = torch.mean(probs, dim=(0, 1))
    aux = num_experts * torch.sum(frac * mean_prob)
    return gate_vals, expert_ids, aux


def _expert(p: MoE, e: int, x_e: torch.Tensor, rules=None) -> torch.Tensor:
    x_e = constrain(x_e, rules, "dp", None, None)
    g = constrain(x_e @ p.w_gate[e], rules, "dp", None, "tensor")
    u = constrain(x_e @ p.w_up[e], rules, "dp", None, "tensor")
    return constrain((F.silu(g) * u) @ p.w_down[e], rules, "dp", None, None)


def moe_forward(p: MoE, x: torch.Tensor, *, num_experts: int, top_k: int,
                capacity_factor: float = 1.25, rules=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (G, T, d) (decode: (1, B, d), the batch is the group). Returns (out in
    x's dtype, aux float32).

    On a DTensor x (sharded on the group axis at most) the router and the
    expert products are DTensor ops; the dispatch's index work (sort, gathers,
    the index writes), for which DTensor has no rules, runs on each rank's own
    groups, its tensors taken to and from their local shards by hand."""
    G, T, d = x.shape
    E, k = num_experts, top_k
    C = capacity(capacity_factor, k, T, E)

    gate_vals, expert_ids, aux = route(p, x, E, k, rules)
    local = _Local(x) if is_dtensor(x) else None
    if local is not None:
        x, gate_vals, expert_ids = local.down(x), local.down(gate_vals), local.down(expert_ids)
        G = x.shape[0]
    dev = x.device
    flat_expert = expert_ids.reshape(G, T * k)
    flat_gate = gate_vals.reshape(G, T * k)
    flat_tok = (torch.arange(T * k, device=dev) // k).expand(G, T * k)  # no host sync, unlike repeat_interleave

    order = torch.argsort(flat_expert, dim=1, stable=True)
    sorted_tok = torch.gather(flat_tok, 1, order)
    sorted_gate = torch.gather(flat_gate, 1, order)
    counts = _one_hot(flat_expert, E).sum(dim=1)  # (G, E)
    starts = torch.cumsum(counts, dim=1) - counts
    if _COUNTER is not None:
        _COUNTER.add(G * T * k, torch.clamp_min(counts - C, 0).sum(), counts.sum(dim=0))

    # One scratch row past the last token takes the writes of unkept slots.
    out = torch.zeros((G, T + 1, d), dtype=x.dtype, device=dev)
    slot = torch.arange(C, device=dev)
    rows = torch.arange(G, device=dev)[:, None].expand(G, C)
    for e in range(E):
        idx = torch.clamp_max(starts[:, e : e + 1] + slot[None, :], T * k - 1)  # (G, C)
        keep = slot[None, :] < torch.clamp_max(counts[:, e : e + 1], C)
        tok_e = torch.gather(sorted_tok, 1, idx)
        gate_e = torch.gather(sorted_gate, 1, idx) * keep
        x_e = x[rows, tok_e]  # (G, C, d)
        if local is None:
            y = _expert(p, e, x_e, rules)
        else:
            y = local.down(_expert(p, e, local.up(x_e), rules))
        y = y * gate_e[..., None].to(x.dtype)
        dst = torch.where(keep, tok_e, T)
        out.index_put_((rows, dst), out[rows, dst] + y)
    return (out[:, :T] if local is None else local.up(out[:, :T])), aux



class _Local:
    """Moves tensors whose first axis is the group axis between DTensors placed
    as ``x`` with the group axis kept sharded and everything else whole (the
    decode's group, the batch, is x's second axis: gathered) and their local
    shards."""

    def __init__(self, x):
        from torch.distributed.tensor import Replicate, Shard

        self.mesh = x.device_mesh
        self.placements = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
        self.groups = x.shape[0]

    def down(self, t):
        return as_dtensor(t, self.mesh).redistribute(self.mesh, self.placements).to_local()

    def up(self, t):
        return from_local(t, self.mesh, self.placements, (self.groups,) + tuple(t.shape[1:]))


def moe_dense_fallback(p: MoE, x: torch.Tensor, *, num_experts: int, top_k: int):
    """Every expert on every token, combined with the gate weights (no capacity):
    the reference's check of the dispatch path. Returns (out, aux)."""
    gate_vals, expert_ids, aux = route(p, x, num_experts, top_k)
    g = torch.einsum("gtd,edf->getf", x, p.w_gate)
    u = torch.einsum("gtd,edf->getf", x, p.w_up)
    y = torch.einsum("getf,efd->getd", F.silu(g) * u, p.w_down)
    combine = torch.sum(F.one_hot(expert_ids, num_experts).to(y.dtype) * gate_vals[..., None].to(y.dtype), dim=2)
    return torch.einsum("gte,getd->gtd", combine, y), aux
