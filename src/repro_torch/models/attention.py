"""Attention of the port: GQA with chunked online-softmax (flash-style) attention
for training and prefill, and one-token decode against a KV cache.

Port of the GQA half of ``repro.models.attention`` (MLA and cross-attention decode
come with their families). The algorithm is the reference's, in plain PyTorch:
``chunked_attention`` walks the keys in chunks with a running (max, sum) pair, so
its peak memory is O(S·chunk), and runs in float32 whatever the activations'
dtype (q is scaled in its own dtype first, as the reference does). Heads are
grouped kv-major: head h reads kv head h // (H / KV).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models import layers
from repro_torch.utils import prng

NEG_INF = -1e30


def _window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor | None:
    """(Sq, Sk) bool window mask; ``window <= 0`` means no window (full attention)."""
    if window <= 0:
        return None
    return q_pos[:, None] - k_pos[None, :] < window


# ------------------------------------------------------------------ GQA params


class GQA(nn.Module):
    """One GQA block's projections, (in, out) orientation: wq (d, H·hd), wk and wv
    (d, KV·hd), wo (H·hd, d)."""

    def __init__(self, wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (layers._param(t) for t in (wq, wk, wv, wo))


def init_gqa(key: torch.Tensor, d: int, heads: int, kv_heads: int, head_dim: int, dtype: torch.dtype,
             device) -> GQA:
    kq, kk, kv, ko = prng.split(key, 4)
    return GQA(
        layers.dense_init(kq, (d, heads * head_dim), d, dtype, device),
        layers.dense_init(kk, (d, kv_heads * head_dim), d, dtype, device),
        layers.dense_init(kv, (d, kv_heads * head_dim), d, dtype, device),
        layers.dense_init(ko, (heads * head_dim, d), heads * head_dim, dtype, device),
    )


# ------------------------------------------------------------------ flash core


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention. q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd).

    GQA reshapes H into (KV, H // KV) groups. ``window > 0`` restricts each query to
    the last ``window`` keys. The keys are zero-padded to whole chunks and the
    padding is masked (``k_pos < Sk``); nothing else is masked beyond causality
    and the window. Returns (B, Sq, H, hd_v) in q's dtype.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    hd_v = v.shape[3]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)

    qf = (q.reshape(B, Sq, KV, G, hd) * scale).to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)

    n_chunks = -(-Sk // chunk)
    Sk_pad = n_chunks * chunk
    if Sk_pad != Sk:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, 0, 0, Sk_pad - Sk))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, Sk_pad - Sk))

    dev = q.device
    q_pos = torch.arange(Sq, device=dev)
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, hd_v), dtype=torch.float32, device=dev)
    for j in range(n_chunks):
        kj = kf[:, j * chunk : (j + 1) * chunk]
        vj = vf[:, j * chunk : (j + 1) * chunk]
        k_pos = j * chunk + torch.arange(chunk, device=dev)
        s = torch.einsum("bqkgh,bckh->bqkgc", qf, kj)  # (B, Sq, KV, G, chunk)
        mask = (k_pos < Sk)[None, :].expand(Sq, chunk)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        wm = _window_mask(q_pos, k_pos, window)
        if wm is not None:
            mask = mask & wm
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        del s
        l_corr = torch.exp(m - m_new)
        l = l * l_corr + torch.sum(p, dim=-1)
        acc = acc * l_corr[..., None] + torch.einsum("bqkgc,bckh->bqkgh", p, vj)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, Sq, H, hd_v).to(q.dtype)


# ------------------------------------------------------------------ GQA forward


def gqa_forward(p: GQA, x: torch.Tensor, *, heads: int, kv_heads: int, head_dim: int, rope_theta: float,
                rope_fraction: float = 1.0, window: int = 0, chunk: int = 1024, return_kv: bool = False):
    """Causal self attention over x: (B, S, d), rotary at positions 0..S-1.

    ``return_kv=True`` also returns the post-RoPE (k, v), (B, S, KV, hd) each:
    exactly what a decode cache stores (the batched prefill's path)."""
    B, S, _ = x.shape
    q = (x @ p.wq).reshape(B, S, heads, head_dim)
    k = (x @ p.wk).reshape(B, S, kv_heads, head_dim)
    v = (x @ p.wv).reshape(B, S, kv_heads, head_dim)
    cos, sin = layers.rope_angles(torch.arange(S, device=x.device), int(head_dim * rope_fraction) & ~1, rope_theta)
    q = layers.apply_rope(q, cos[None], sin[None], rope_fraction)
    k = layers.apply_rope(k, cos[None], sin[None], rope_fraction)
    out = chunked_attention(q, k, v, window=window, chunk=chunk)
    out = out.reshape(B, S, heads * head_dim) @ p.wo
    if return_kv:
        return out, (k, v)
    return out


def decode_tables(pos: int, s_cache: int, rot: int, theta: float, device):
    """What every layer's one-token decode at position ``pos`` shares: the rotary
    (cos, sin) of ``pos`` ((1, rot/2) each), the ring slot that ``pos`` is written
    to in a cache of ``s_cache`` entries, and which entries are valid. Entry i
    holds position pos − ((pos − i) mod s_cache), valid where that is >= 0 (the
    reference's ring rule); a full-attention cache is the ring with s_cache =
    max_len, where this is i <= pos."""
    cos, sin = layers.rope_angles(torch.full((1,), pos, dtype=torch.int64, device=device), rot, theta)
    idx = torch.arange(s_cache, device=device)
    valid = pos - torch.remainder(pos - idx, s_cache) >= 0
    return cos, sin, pos % s_cache, valid


def gqa_decode(p: GQA, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, tables, *, heads: int,
               kv_heads: int, head_dim: int, rope_fraction: float = 1.0) -> torch.Tensor:
    """One-token decode (the reference's ``_gqa_ring_decode``; its ``gqa_decode``
    is the same for a cache longer than the position). x: (B, 1, d);
    cache_k/v: (B, Sc, KV, hd), written in place at the ring slot; ``tables`` is
    :func:`decode_tables` of the current position. Scores, softmax and the value
    sum run in float32 over a float32 copy of the whole cache, masked to the
    valid entries. Returns out (B, 1, d)."""
    cos, sin, slot, valid = tables
    B = x.shape[0]
    q = (x @ p.wq).reshape(B, 1, heads, head_dim)
    k = (x @ p.wk).reshape(B, 1, kv_heads, head_dim)
    v = (x @ p.wv).reshape(B, 1, kv_heads, head_dim)
    q = layers.apply_rope(q, cos[None], sin[None], rope_fraction)
    k = layers.apply_rope(k, cos[None], sin[None], rope_fraction)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)

    G = heads // kv_heads
    qf = (q.to(torch.float32) / math.sqrt(head_dim)).reshape(B, kv_heads, G, head_dim)
    s = torch.einsum("bkgh,bskh->bkgs", qf, cache_k.to(torch.float32))  # (B, KV, G, Sc)
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", pr, cache_v.to(torch.float32)).reshape(B, 1, heads * head_dim)
    return out.to(x.dtype) @ p.wo
