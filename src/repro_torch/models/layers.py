"""Shared neural-net layers of the port: norms, rotary embeddings, the SwiGLU FFN,
embeddings and the cross-entropy loss.

Port of ``repro.models.layers``. The apply functions take the weight tensors and
compute what the reference computes, in the same dtypes (norms, rotary angles and
the loss in float32; products in the activations' dtype). Each layer's weights live
in a small ``nn.Module``; weights keep the reference's (in, out) orientation, so a
product is ``x @ w``. ``init_*`` draw every leaf as the reference does: jax's
normal under the same key (``prng.normal``), times 1/√fan_in (0.02 for the
embedding table) in float32, rounded to the layer's dtype, in pieces of whole rows
on the target device (never a float32 copy of a whole large leaf).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.utils import prng

# Elements of one float32 piece of a weight draw: bounds the draw's int64
# threefry temporaries to a few hundred MB on the card.
DRAW_PIECE = 1 << 24


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


@torch.no_grad()
def draw_normal(key: torch.Tensor, shape: tuple, scale: float, dtype: torch.dtype, device, *,
                divide: bool = False) -> torch.Tensor:
    """``(jax.random.normal(key, shape) * scale).astype(dtype)``, drawn in pieces of
    whole rows of the last axis (the flat indices of a piece are its offset in
    the whole draw, so the pieces are the whole draw's values). ``divide``:
    ``normal / scale`` instead, a float32 division (not a product by the
    rounded reciprocal, which differs by an ulp on many entries): the
    reference's ``vit_proj``."""
    shape = tuple(shape)
    cols = shape[-1]
    flat_rows = math.prod(shape[:-1])
    out = torch.empty((flat_rows, cols), dtype=dtype, device=device)
    # A divisor held as a tensor on the draw's device: CUDA's division by a host
    # scalar multiplies by its reciprocal.
    divisor = torch.tensor(scale, dtype=torch.float32, device=device) if divide else None
    step = max(1, DRAW_PIECE // cols)
    for r0 in range(0, flat_rows, step):
        r = min(step, flat_rows - r0)
        piece = prng.normal(key, (r, cols), offset=r0 * cols, device=device)
        out[r0 : r0 + r] = (piece / divisor if divide else piece * scale).to(dtype)
    return out.reshape(shape)


def dense_init(key, shape: tuple, fan_in: int, dtype: torch.dtype, device) -> torch.Tensor:
    return draw_normal(key, shape, 1.0 / math.sqrt(fan_in), dtype, device)


# ------------------------------------------------------------------ norms


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = _param(scale)

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        return rmsnorm(self.scale, x, eps)


def init_rmsnorm(d: int, dtype: torch.dtype, device) -> RMSNorm:
    return RMSNorm(torch.ones((d,), dtype=dtype, device=device))


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(dtype)


# ------------------------------------------------------------------ rotary


def rope_angles(positions: torch.Tensor, dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embedding. positions: (...,) int; dim must be even.
    Returns (cos, sin) of shape positions.shape + (dim//2,), float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, fraction: float = 1.0) -> torch.Tensor:
    """Rotate the first ``fraction`` of the head dim of x: (..., S, H, hd).

    cos/sin: (..., S, rot/2) broadcast over heads. The rotated pairs are
    interleaved dims (0, 1), (2, 3), …; ChatGLM-style 2d rope is fraction=0.5
    (the second half of the head dim passes through unrotated). The rotation is
    in float32, the result in x's dtype.
    """
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    xr = x_rot.reshape(*x_rot.shape[:-1], rot // 2, 2)
    x1, x2 = xr[..., 0], xr[..., 1]
    c = cos[..., None, : rot // 2]
    s = sin[..., None, : rot // 2]
    y1 = x1 * c - x2 * s
    y2 = x1 * s + x2 * c
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape).to(x.dtype)
    return torch.cat([y, x_pass], dim=-1) if rot < hd else y


# ------------------------------------------------------------------ FFN (SwiGLU)


class SwiGLU(nn.Module):
    def __init__(self, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = _param(w_gate), _param(w_up), _param(w_down)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(self.w_gate, self.w_up, self.w_down, x)


def init_swiglu(key: torch.Tensor, d: int, f: int, dtype: torch.dtype, device) -> SwiGLU:
    k1, k2, k3 = prng.split(key, 3)
    return SwiGLU(dense_init(k1, (d, f), d, dtype, device), dense_init(k2, (d, f), d, dtype, device),
                  dense_init(k3, (f, d), f, dtype, device))


def swiglu(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g) * u) @ w_down


# ------------------------------------------------------------------ embeddings


class Embedding(nn.Module):
    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = _param(table)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed(self.table, tokens)


def init_embedding(key: torch.Tensor, vocab: int, d: int, dtype: torch.dtype, device) -> Embedding:
    return Embedding(draw_normal(key, (vocab, d), 0.02, dtype, device))


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    if sharding.is_dtensor(table):
        return _sharded_embed(table, tokens)
    return table[tokens.to(device=table.device, dtype=torch.int64)]


def _sharded_embed(table, tokens):
    """The lookup on a DTensor table, by hand on each rank's shards (Megatron's
    vocab-parallel embedding): whole rows of the rank's vocabulary shard, the
    tokens batch-sharded where the vocabulary is not, each rank's lookup of
    the tokens outside its shard zeroed, and the result a partial sum over the
    vocabulary's mesh dimensions. The table's gradient is a partial sum where
    the tokens are batch-sharded. (DTensor's own rule for the lookup's
    backward, an accumulating ``index_put``, fails on some torch versions.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    vocab = [p == Shard(0) for p in table.placements]
    tok = sharding.as_dtensor(tokens.to(dtype=torch.int64), mesh)
    batch = [p == Shard(0) and not v for p, v in zip(tok.placements, vocab)]
    rows_pl = tuple(Shard(0) if v else Replicate() for v in vocab)
    grad_pl = tuple(Shard(0) if v else Partial() if b else Replicate() for v, b in zip(vocab, batch))
    out_pl = tuple(Partial() if v else Shard(0) if b else Replicate() for v, b in zip(vocab, batch))
    t_l = table.redistribute(mesh, rows_pl).to_local(grad_placements=grad_pl)
    idx = tok.redistribute(mesh, tuple(Shard(0) if b else Replicate() for b in batch)).to_local()
    held = sharding.local_slices(table.shape, mesh, rows_pl)[0]
    if held.stop == held.start:
        raise ValueError(f"a rank holds no rows of the {table.shape[0]}-row table")
    idx = idx - held.start
    inside = (idx >= 0) & (idx < held.stop - held.start)
    out = t_l[torch.clamp(idx, 0, held.stop - held.start - 1)]
    if any(vocab):
        out = torch.where(inside[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    return sharding.from_local(out, mesh, out_pl, tuple(tokens.shape) + (table.shape[1],))


class Unembed(nn.Module):
    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = _param(w)


def init_unembed(key: torch.Tensor, d: int, vocab: int, dtype: torch.dtype, device) -> Unembed:
    return Unembed(dense_init(key, (d, vocab), d, dtype, device))


def unembed(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w


# ------------------------------------------------------------------ losses


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE. logits: (..., V) any dtype; computed in float32."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.to(torch.int64)[..., None], dim=-1)[..., 0]
    nll = logz - gold
    if mask is not None:
        m = mask.to(torch.float32)
        return torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
    return torch.mean(nll)
