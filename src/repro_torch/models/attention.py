"""Attention of the port: GQA and MLA with chunked online-softmax (flash-style)
attention for training and prefill, and one-token decode against a cache.

Port of ``repro.models.attention``: GQA self attention (causal with RoPE, or
bidirectional without it: the encoder's), cross attention to an encoder's
output (``kv_source``; ``cross_decode`` against the cached encoder keys and
values), MLA. The algorithm is the reference's, in plain PyTorch:
``chunked_attention`` walks the keys in chunks with a running (max, sum) pair, so
its peak memory is O(S·chunk), and runs in float32 whatever the activations'
dtype (q is scaled in its own dtype first, as the reference does). Heads are
grouped kv-major: head h reads kv head h // (H / KV).

MLA (multi-head latent attention, minicpm3) caches only the latent c_kv and the
rotated shared key k_rope, (kv_lora + rope_d) values a position. Its prefill
expands the latent to per-head keys and values for ``chunked_attention``; its
decode is the absorbed form: W_uk folds into the query, the scores run against
the latent cache, and the values stay latent until W_uv.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain, is_dtensor
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
                      chunk: int = 1024, rules=None, seq_axis="sp") -> torch.Tensor:
    """Online-softmax attention. q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd).

    GQA reshapes H into (KV, H // KV) groups. ``window > 0`` restricts each query to
    the last ``window`` keys. The keys are zero-padded to whole chunks and the
    padding is masked (``k_pos < Sk``); nothing else is masked beyond causality
    and the window. Returns (B, Sq, H, hd_v) in q's dtype.

    Sequence-parallel under ``rules``: the queries (and with them the scores and
    accumulators) are sharded on Sq over the tensor axis, before the float32
    cast, and the keys and values are whole. On DTensors that is done by hand
    (:func:`_sharded_attention`): the keys and values are redistributed to the
    queries' batch sharding, replicated on the rest of the mesh, and each rank
    attends its own queries at their global positions on its local shards.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    q5 = constrain(q.reshape(B, Sq, KV, H // KV, hd), rules, "dp", seq_axis, None, None, None)
    if is_dtensor(q5):
        return _sharded_attention(q5, k, v, causal=causal, window=window, chunk=chunk)
    return _attend(q5, k, v, 0, causal=causal, window=window, chunk=chunk)


def _attend(q5: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int, *, causal: bool, window: int,
            chunk: int) -> torch.Tensor:
    """The online softmax of q5 (B, Sq, KV, G, hd), whose query i sits at
    position ``q_offset + i``, over k, v (B, Sk, KV, hd): (B, Sq, H, hd_v)."""
    B, Sq, KV, G, hd = q5.shape
    Sk = k.shape[1]
    hd_v = v.shape[3]
    scale = 1.0 / math.sqrt(hd)

    qf = (q5 * scale).to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)

    n_chunks = -(-Sk // chunk)
    Sk_pad = n_chunks * chunk
    if Sk_pad != Sk:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, 0, 0, Sk_pad - Sk))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, Sk_pad - Sk))

    dev = q5.device
    q_pos = torch.arange(q_offset, q_offset + Sq, device=dev)
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
    return out.reshape(B, Sq, KV * G, hd_v).to(q5.dtype)



def _sharded_attention(q5, k, v, *, causal: bool, window: int, chunk: int):
    """:func:`_attend` on each rank's shards of the DTensor q5: k and v go to
    q5's batch placements and are replicated over the mesh's other
    dimensions; this rank's queries start at their global offset. Where the
    queries are sharded on the sequence, each rank's gradient of k and v
    holds only its own queries' share: it is a partial sum there."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, qp = q5.device_mesh, tuple(q5.placements)
    if any(not isinstance(p, (Shard, Replicate)) or (isinstance(p, Shard) and p.dim > 1) for p in qp):
        raise ValueError(f"queries placed {qp}: only the batch and sequence dims may be sharded")
    kvp = tuple(p if p == Shard(0) else Replicate() for p in qp)
    grad_pl = tuple(Partial() if p == Shard(1) else kv for p, kv in zip(qp, kvp))
    k_l = sharding.as_dtensor(k, mesh).redistribute(mesh, kvp).to_local(grad_placements=grad_pl)
    v_l = sharding.as_dtensor(v, mesh).redistribute(mesh, kvp).to_local(grad_placements=grad_pl)
    offset = sharding.local_slices(q5.shape, mesh, qp)[1].start
    out = _attend(q5.to_local(), k_l, v_l, offset, causal=causal, window=window, chunk=chunk)
    B, Sq, KV, G, _ = q5.shape
    return sharding.from_local(out, mesh, qp, (B, Sq, KV * G, v.shape[3]))


# ------------------------------------------------------------------ GQA forward


def gqa_forward(p: GQA, x: torch.Tensor, *, heads: int, kv_heads: int, head_dim: int, rope_theta: float,
                rope_fraction: float = 1.0, causal: bool = True, window: int = 0, chunk: int = 1024,
                kv_source: torch.Tensor | None = None, return_kv: bool = False, rules=None):
    """Self attention over x: (B, S, d), or cross attention from x to
    ``kv_source`` (B, Sk, d) (the keys and values its projections).

    Rotary at positions 0..S-1 only for causal self attention (``causal`` and
    no ``kv_source``), as in the reference: the encoder's bidirectional self
    attention (``causal=False``) and cross attention rotate nothing, and cross
    attention masks nothing. ``return_kv=True`` also returns (k, v), (B, Sk,
    KV, hd) each, post-RoPE where rotated: exactly what a decode cache stores
    (the batched prefill's path)."""
    B, S, _ = x.shape
    src = x if kv_source is None else kv_source
    Sk = src.shape[1]
    sp = _seq_axis(x, S, rules)
    q = _split_heads(x @ p.wq, (B, S, heads, head_dim), rules, sp)
    k = _split_heads(src @ p.wk, (B, Sk, kv_heads, head_dim), rules, None)
    v = _split_heads(src @ p.wv, (B, Sk, kv_heads, head_dim), rules, None)
    self_causal = causal and kv_source is None
    if self_causal:
        cos, sin = layers.rope_angles(torch.arange(S, device=x.device), int(head_dim * rope_fraction) & ~1,
                                      rope_theta)
        q = layers.apply_rope(q, cos[None], sin[None], rope_fraction)
        k = layers.apply_rope(k, cos[None], sin[None], rope_fraction)
    out = chunked_attention(q, k, v, causal=self_causal, window=window, chunk=chunk, rules=rules, seq_axis=sp)
    out = _merge_heads(out, (B, S, heads * head_dim), rules) @ p.wo
    if return_kv:
        return out, (k, v)
    return out


def _seq_axis(x: torch.Tensor, S: int, rules):
    """The queries' sequence axis: "sp", or None (whole) on a DTensor whose S
    the tensor axis does not divide (whisper's 1,500 frames over 16): DTensor's
    uneven shard-to-shard redistribution on the CPU leaves a mis-strided local
    shard that its next view cannot take."""
    if rules is None or not is_dtensor(x) or rules.resolve("sp") is None:
        return "sp"
    from repro_torch.utils.compat import axis_size

    return "sp" if S % axis_size(x.device_mesh, rules.resolve("sp")) == 0 else None


def _split_heads(t: torch.Tensor, shape: tuple, rules, seq_axis) -> torch.Tensor:
    """``t`` (B, S, heads·hd) reshaped to ``shape`` (B, S, heads, hd). Under
    ``rules`` a projection is first redistributed to (dp, ``seq_axis``, whole):
    its last dim is tensor-sharded and a head count the tensor axis does not
    divide cannot be split on the shards (keys and values go whole, as the
    sequence-parallel attention reads them; queries sequence-sharded)."""
    return constrain(t, rules, "dp", seq_axis, None).reshape(shape)


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """cache[:, slot] = new[:, 0] in the cache's dtype (a DTensor cache: by the
    rank that holds the slot)."""
    if is_dtensor(cache):
        sharding.write_slots(cache, new, [slot], [0])
    else:
        cache[:, slot] = new[:, 0].to(cache.dtype)


def _merge_heads(out: torch.Tensor, shape: tuple, rules) -> torch.Tensor:
    """(B, S, heads, hd) → ``shape`` (B, S, heads·hd). On a DTensor the merge is
    followed by a redistribution, under ``rules`` to (dp, whole, whole) (the
    output projection cannot flatten a sharded sequence), else to its own
    placements; either way its backward brings the gradient, tensor-sharded
    on heads·hd by the output projection, back to the merged placements
    before it is split into heads again (a head count the tensor axis does
    not divide cannot be split on shards)."""
    out = out.reshape(shape)
    if is_dtensor(out):
        mesh = out.device_mesh
        pl = out.placements if rules is None else sharding.to_placements(rules.spec("dp", None, "tensor"), mesh)
        out = out.redistribute(mesh, pl)
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
               kv_heads: int, head_dim: int, rope_fraction: float = 1.0, rules=None) -> torch.Tensor:
    """One-token decode (the reference's ``_gqa_ring_decode``; its ``gqa_decode``
    is the same for a cache longer than the position). x: (B, 1, d);
    cache_k/v: (B, Sc, KV, hd), written in place at the ring slot; ``tables`` is
    :func:`decode_tables` of the current position. Scores, softmax and the value
    sum run in float32 over a float32 copy of the whole cache, masked to the
    valid entries. Returns out (B, 1, d)."""
    cos, sin, slot, valid = tables
    B = x.shape[0]
    q = _split_heads(x @ p.wq, (B, 1, heads, head_dim), rules, None)
    k = _split_heads(x @ p.wk, (B, 1, kv_heads, head_dim), rules, None)
    v = _split_heads(x @ p.wv, (B, 1, kv_heads, head_dim), rules, None)
    q = layers.apply_rope(q, cos[None], sin[None], rope_fraction)
    k = layers.apply_rope(k, cos[None], sin[None], rope_fraction)
    _write_slot(cache_k, k, slot)
    _write_slot(cache_v, v, slot)

    G = heads // kv_heads
    qf = (q.to(torch.float32) / math.sqrt(head_dim)).reshape(B, kv_heads, G, head_dim)
    s = torch.einsum("bkgh,bskh->bkgs", qf, cache_k.to(torch.float32))  # (B, KV, G, Sc)
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", pr, cache_v.to(torch.float32)).reshape(B, 1, heads * head_dim)
    return out.to(x.dtype) @ p.wo


# ------------------------------------------------------------------ cross-attention decode


def cross_decode(p: GQA, x: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor, *, heads: int, kv_heads: int,
                 head_dim: int, rules=None) -> torch.Tensor:
    """One-token cross attention against the encoder's keys and values (the
    whisper decode). x: (B, 1, d); xk, xv: (B, S_enc, KV, hd), computed once at
    prefill from the encoder output and held in the decode cache, read here and
    never written. q unrotated and scaled by 1/√hd, then scores, softmax and the
    value sum in float32 over float32 copies of xk and xv, with no mask (every
    frame is visible); the output cast to x's dtype before ``wo``. Returns out
    (B, 1, d)."""
    B = x.shape[0]
    G = heads // kv_heads
    q = _split_heads(x @ p.wq, (B, 1, heads, head_dim), rules, None).reshape(B, heads, head_dim)
    qf = (q.to(torch.float32) / math.sqrt(head_dim)).reshape(B, kv_heads, G, head_dim)
    s = torch.einsum("bkgh,bskh->bkgs", qf, xk.to(torch.float32))
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", pr, xv.to(torch.float32)).reshape(B, 1, heads * head_dim)
    return out.to(x.dtype) @ p.wo


# ------------------------------------------------------------------ MLA


class MLA(nn.Module):
    """One MLA block's projections, (in, out) orientation: w_dq (d, q_lora), w_uq
    (q_lora, H·(nope + rope_d)), w_dkv (d, kv_lora + rope_d), w_ukv (kv_lora,
    H·(nope + v)), wo (H·v, d)."""

    LEAVES = ("w_dq", "w_uq", "w_dkv", "w_ukv", "wo")

    def __init__(self, **leaves: torch.Tensor):
        super().__init__()
        for name in self.LEAVES:
            setattr(self, name, layers._param(leaves[name]))


def init_mla(key: torch.Tensor, d: int, heads: int, *, q_lora: int, kv_lora: int, nope: int, rope_d: int,
             v_dim: int, dtype: torch.dtype, device) -> MLA:
    ks = prng.split(key, 6)
    return MLA(
        w_dq=layers.dense_init(ks[0], (d, q_lora), d, dtype, device),
        w_uq=layers.dense_init(ks[1], (q_lora, heads * (nope + rope_d)), q_lora, dtype, device),
        w_dkv=layers.dense_init(ks[2], (d, kv_lora + rope_d), d, dtype, device),
        w_ukv=layers.dense_init(ks[3], (kv_lora, heads * (nope + v_dim)), kv_lora, dtype, device),
        wo=layers.dense_init(ks[4], (heads * v_dim, d), heads * v_dim, dtype, device),
    )


def mla_forward(p: MLA, x: torch.Tensor, *, heads: int, kv_lora: int, nope: int, rope_d: int, v_dim: int,
                rope_theta: float, chunk: int = 1024, return_kv: bool = False, rules=None):
    """Causal MLA over x: (B, S, d): the latent expanded to per-head K (nope, then
    the one rotated k_rope every head shares) and V, then ``chunked_attention``
    (q and k of nope + rope_d values, v of v_dim; scale 1/√(nope + rope_d)).

    ``return_kv=True`` also returns (c_kv (B, S, kv_lora), k_rope (B, S,
    rope_d)), k_rope after its rotation: the latent decode cache."""
    B, S, _ = x.shape
    sp = _seq_axis(x, S, rules)
    q = _split_heads((x @ p.w_dq) @ p.w_uq, (B, S, heads, nope + rope_d), rules, sp)
    ckv_full = x @ p.w_dkv
    ckv, k_rope = ckv_full[..., :kv_lora], ckv_full[..., kv_lora:]
    kv = _split_heads(ckv @ p.w_ukv, (B, S, heads, nope + v_dim), rules, None)
    k_nope, v = kv[..., :nope], kv[..., nope:]

    cos, sin = layers.rope_angles(torch.arange(S, device=x.device), rope_d, rope_theta)
    q_rope = layers.apply_rope(q[..., nope:], cos[None], sin[None])
    k_rope1 = layers.apply_rope(k_rope[:, :, None, :], cos[None], sin[None])  # (B, S, 1, rope_d)
    q_full = torch.cat([q[..., :nope], q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope1.expand(B, S, heads, rope_d)], dim=-1)
    out = chunked_attention(q_full, k_full, v, chunk=chunk, rules=rules, seq_axis=sp)
    out = _merge_heads(out, (B, S, heads * v_dim), rules) @ p.wo
    if return_kv:
        return out, (ckv, k_rope1[:, :, 0, :])
    return out


def mla_decode(p: MLA, x: torch.Tensor, cache_ckv: torch.Tensor, cache_krope: torch.Tensor, tables, *, heads: int,
               kv_lora: int, nope: int, rope_d: int, v_dim: int, rules=None) -> torch.Tensor:
    """Absorbed one-token MLA decode. x: (B, 1, d); cache_ckv (B, Sc, kv_lora) and
    cache_krope (B, Sc, rope_d), written in place at the slot of ``tables``
    (:func:`decode_tables` of the position, rot = rope_d). The query absorbs
    W_uk (q_lat = q_nope·W_uk in the model dtype); scores q_lat·c_kv +
    q_rope·k_rope, scaled by 1/√(nope + rope_d), and the softmax in float32
    over float32 copies of the latent cache; the value sum stays latent (B, H,
    kv_lora) until W_uv. The cache is never expanded to per-head K and V.
    Returns out (B, 1, d)."""
    cos, sin, slot, valid = tables
    B = x.shape[0]
    w = p.w_ukv.reshape(kv_lora, heads, nope + v_dim)
    w_uk, w_uv = w[:, :, :nope], w[:, :, nope:]

    q = _split_heads((x @ p.w_dq) @ p.w_uq, (B, 1, heads, nope + rope_d), rules, None).reshape(B, heads, nope + rope_d)
    q_nope = q[..., :nope]
    q_rope = layers.apply_rope(q[:, None, :, nope:], cos[None], sin[None])[:, 0]
    ckv_full = (x @ p.w_dkv)[:, 0]
    krope_new = layers.apply_rope(ckv_full[:, None, None, kv_lora:], cos[None], sin[None])[:, 0, 0]
    _write_slot(cache_ckv, ckv_full[:, None, :kv_lora], slot)
    _write_slot(cache_krope, krope_new[:, None], slot)

    ckv_f = cache_ckv.to(torch.float32)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope, w_uk).to(torch.float32)
    s = torch.einsum("bhr,bsr->bhs", q_lat, ckv_f)
    s = s + torch.einsum("bhp,bsp->bhs", q_rope.to(torch.float32), cache_krope.to(torch.float32))
    s = s * (1.0 / math.sqrt(nope + rope_d))
    s = torch.where(valid[None, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", pr, ckv_f)  # (B, H, kv_lora)
    out = torch.einsum("bhr,rhv->bhv", o_lat.to(x.dtype), w_uv).reshape(B, 1, heads * v_dim)
    return out @ p.wo
