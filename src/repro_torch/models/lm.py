"""The decoder LM of the port: parameters, forward, KV cache, decode and prefill.

Port of ``repro.models.lm`` for the decoder families: dense (SwiGLU; RoPE at
any ``rope_fraction``: granite-3-8b, chatglm3-6b), MoE (``models.moe``:
mixtral-8x7b, grok-1-314b), sliding-window attention (mixtral's ``window``),
gemma3's local:global pattern (``local_global_ratio`` windowed layers, then one
global), MLA (``attention.mla_*``: minicpm3-4b), the hybrid layer (hymba-1.5b:
GQA with a window beside a Mamba branch of ``models.ssm``, both reading the
same normed input, fused as rmsnorm(a)·β_a + rmsnorm(s)·β_s), the
attention-free SSM stack (falcon-mamba-7b: each layer x + mamba(norm1(x)),
no attention, ``norm2`` or FFN), the
encoder-decoder (whisper-small: a bidirectional :class:`EncoderLayer` stack
over precomputed frame embeddings, ``encoder_forward``, and in every decoder
layer a cross-attention block, ``norm_x`` and ``xattn``, after the self
attention) and the VLM (pixtral-12b: ``vit_proj`` projects precomputed patch
embeddings into the first P positions, ``embed_inputs``). A model is an
:class:`LM` module: the embedding, an ``nn.ModuleList`` of :class:`DecoderLayer`
looped in Python, the final norm and the unembedding (and an encoder-decoder's
``enc_layers`` and ``enc_norm``, a VLM's ``vit_proj``). As in the reference,
RoPE rotates only the decoder's causal self attention: the encoder's self
attention and cross attention have no positions (the frame stub carries none).
Weights keep the reference's (in, out) orientation; the functions mirror the
reference's (``forward_logits(params, cfg, batch)`` and so on) with ``params``
the module. Inference runs under ``torch.inference_mode()`` (``torch.no_grad()``
for a sharded model: a DTensor weight's view is not an inference tensor).

Sharding: every entry point takes the reference's ``rules``
(``distributed.sharding``) and calls ``constrain`` at the reference's points
(each layer's input, the MoE block's input and output, the encoder layer's
input, the queries, the loss chunk's and the decode's and prefill's logits).
With ``rules=None``, or plain tensors, ``constrain`` is the identity and every
result is what it is without it. A model whose parameters are DTensors runs
its entry points under ``implicit_replication``, so the tables the forward
makes as plain tensors (RoPE, positions, masks) join the DTensor ops
replicated; the loss's gold logit over a vocab-sharded chunk is a masked sum
(an exact one: one term and zeros), for which DTensor has a rule and for
``torch.gather`` it has none.

Training (``lm_loss``) differentiates the same forward: ``trunk`` wraps each
layer in ``torch.utils.checkpoint`` by ``ExecPlan.remat`` (``full``: only the
layer's input is kept; ``dots``: the outputs of the weight products are kept,
the rest recomputed; the reference's ``jax.checkpoint`` policies), and the
next-token loss is chunked over the sequence with each chunk's logits
recomputed in the backward pass, so (B, S, V) logits never exist. ``trunk``
also returns the MoE auxiliary loss summed over the layers in float32 (0 for a
dense model), which ``lm_loss`` adds at ``router_aux_coef``.

The decode cache keeps the reference's keys and leaf shapes, allocated once and
written in place: {"k", "v"} of (L, B, S_c, KV, hd), where S_c is max_len, or
``min(window, max_len)`` for sliding-window attention (a ring); for the
local:global pattern {"local": {"k", "v"}, "global": {"k", "v"}}, the G·R
windowed layers' rings and the G global layers' full caches (layer l of group
g = l // (R + 1) is local entry g·R + r or global entry g); for MLA the latent
{"ckv" (L, B, S_c, kv_lora), "krope" (L, B, S_c, rope_d)}; for the hybrid's
Mamba branch {"conv" (L, B, K − 1, C) in the model dtype, "ssm" (L, B, C, N)
float32} beside its ring, and for the attention-free stack those two alone;
for the encoder-decoder, beside "k" and "v", the cross keys and values {"xk",
"xv"} of (L, B, enc_seq, KV, hd), written once by the prefill and only read by
the decode. Every attention cache is the reference's ring, slot p mod S_c for
position p. Every config of the reference's registry is accepted.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention, layers, moe as moe_lib, ssm as ssm_lib
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

# The families ``ArchConfig.family`` names; each is built from the flags its config sets.
FAMILIES = ("decoder", "moe", "ssm", "hybrid", "encdec", "vlm")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a config whose family is none of ``FAMILIES``."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is none of {', '.join(FAMILIES)}")


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def is_sharded(t) -> bool:
    """Whether ``t`` (a tensor, or a module's first parameter) is a DTensor."""
    if isinstance(t, nn.Module):
        t = next(t.parameters(), None)
    return sharding.is_dtensor(t)


@contextlib.contextmanager
def sharded_region(t):
    """For a sharded model or tensor, DTensor's implicit replication (plain
    tensors made inside join its ops replicated), restored to what it was on
    exit (``implicit_replication()`` itself turns it off, which would end an
    enclosing region); else nothing."""
    if not is_sharded(t):
        yield
        return
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def _whole_seq(x: torch.Tensor, rules) -> torch.Tensor:
    """x (B, S, …) gathered whole on the sequence, batch-sharded: what a
    projection reads (a DTensor product cannot flatten a sharded sequence)."""
    return constrain(x, rules, "dp", None, None)


def _inference(fn):
    """Run an entry point ``fn(params, ...)`` under ``torch.inference_mode()``, or
    ``torch.no_grad()`` and :func:`sharded_region` for a sharded model."""
    @functools.wraps(fn)
    def run(params, *args, **kwargs):
        if not is_sharded(params):
            with torch.inference_mode():
                return fn(params, *args, **kwargs)
        with torch.no_grad(), sharded_region(params):
            return fn(params, *args, **kwargs)

    return run


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """Execution knobs, orthogonal to the architecture config."""

    attn_chunk: int = 1024      # flash key-chunk: attention's memory is O(S·attn_chunk)
    loss_chunk: int = 512       # CE vocab-matmul sequence chunk
    ssm_chunk: int = 128        # Mamba scan chunk: its float32 tiles are (B, ssm_chunk, C, N)
    remat: str = "full"         # none | full | dots (applies where autograd records)


def analysis_plan(seq_len: int, *, remat: str = "full") -> ExecPlan:
    """The reference's analysis plan: every chunk one trip (attention, loss, scan)."""
    big = max(seq_len, 1)
    return ExecPlan(attn_chunk=big, loss_chunk=big, ssm_chunk=big, remat=remat)


# ===================================================================== layer windows


def layer_windows(cfg: ArchConfig) -> torch.Tensor:
    """Per-layer attention window (int32 on the CPU, 0 = global/full): the gemma3
    pattern, mixtral's uniform SWA, or all zeros for full attention."""
    if cfg.attn_kind == "local_global" and cfg.local_global_ratio > 0:
        idx = torch.arange(cfg.num_layers)
        return torch.where(idx % (cfg.local_global_ratio + 1) < cfg.local_global_ratio, cfg.window, 0).to(torch.int32)
    if cfg.attn_kind == "swa" and cfg.window > 0:
        return torch.full((cfg.num_layers,), cfg.window, dtype=torch.int32)
    return torch.zeros((cfg.num_layers,), dtype=torch.int32)


def cache_lengths(cfg: ArchConfig, seq_len: int) -> torch.Tensor:
    """Per-layer KV cache length: SWA layers keep a rolling ``window`` buffer (the
    lengths ``init_cache`` gives each layer's ring)."""
    w = layer_windows(cfg)
    return torch.where(w > 0, torch.clamp_max(w, seq_len), seq_len)


# ===================================================================== modules


class Fuse(nn.Module):
    """The hybrid layer's fuse of its attention output a and SSM output s:
    rmsnorm(a)·β_a + rmsnorm(s)·β_s."""

    def __init__(self, norm_a: layers.RMSNorm, norm_s: layers.RMSNorm, beta_a: torch.Tensor, beta_s: torch.Tensor):
        super().__init__()
        self.norm_a, self.norm_s = norm_a, norm_s
        self.beta_a, self.beta_s = layers._param(beta_a), layers._param(beta_s)

    def forward(self, a: torch.Tensor, s: torch.Tensor, eps: float) -> torch.Tensor:
        return self.norm_a(a, eps) * self.beta_a + self.norm_s(s, eps) * self.beta_s


class DecoderLayer(nn.Module):
    """One pre-norm decoder layer, h = norm1(x): x + attn(h) (GQA or MLA), then
    (encoder-decoder) + xattn(norm_x(·)) against the encoder output, then +
    ffn(norm2(·)), the FFN a SwiGLU (``ffn``) or a mixture of experts
    (``moe``). A hybrid layer's mixer is ``fuse``(attn(h), mamba(h)); other
    layers have no ``mamba`` and ``fuse``, and a decoder-only layer no
    ``norm_x`` and ``xattn`` (None). The attention-free SSM layer is x +
    mamba(h) alone: ``attn``, ``norm2`` and the FFN are None."""

    def __init__(self, norm1: layers.RMSNorm, attn: Optional[nn.Module], norm2: Optional[layers.RMSNorm],
                 ffn: Optional[nn.Module], *, mamba: Optional[ssm_lib.Mamba] = None, fuse: Optional[Fuse] = None,
                 norm_x: Optional[layers.RMSNorm] = None, xattn: Optional[attention.GQA] = None):
        super().__init__()
        self.norm1, self.attn, self.mamba, self.fuse, self.norm2 = norm1, attn, mamba, fuse, norm2
        self.norm_x, self.xattn = norm_x, xattn
        if isinstance(ffn, moe_lib.MoE):
            self.moe = ffn
        elif ffn is not None:
            self.ffn = ffn

    def _ffn(self, h: torch.Tensor, cfg: ArchConfig, rules=None):
        """(G, T, d) -> (out, MoE aux loss or None); an MoE groups by the first axis.
        Under ``rules`` an MoE block's sequence axis is local (the dispatch sorts
        along it) and its output goes back to the layer boundary's spec."""
        if cfg.moe:
            f, aux = self.moe(constrain(h, rules, "dp", None, None), num_experts=cfg.num_experts, top_k=cfg.top_k,
                              capacity_factor=cfg.capacity_factor, rules=rules)
            return constrain(f, rules, "dp", "sp", None), aux
        return constrain(self.ffn(h), rules, "dp", "sp", None), None

    def _attn_args(self, cfg: ArchConfig) -> dict:
        if cfg.mla:
            return dict(heads=cfg.num_heads, kv_lora=cfg.kv_lora_rank, nope=cfg.qk_nope_dim, rope_d=cfg.qk_rope_dim,
                        v_dim=cfg.v_head_dim)
        return dict(heads=cfg.num_heads, kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
                    rope_fraction=cfg.rope_fraction)

    def _ssm_args(self, cfg: ArchConfig) -> dict:
        return dict(state=cfg.ssm_state, dt_rank=cfg.resolved_dt_rank)

    def forward(self, x: torch.Tensor, cfg: ArchConfig, window: int, plan: ExecPlan, *, return_kv: bool = False,
                enc_out: Optional[torch.Tensor] = None, rules=None):
        """(B, S, d) -> (x (B, S, d), MoE aux or None, each sequence an MoE group);
        ``enc_out`` (B, enc_seq, d) is what the cross attention reads (without
        it, as in the reference, the cross block attends over its own input,
        bidirectionally). With ``return_kv`` also this layer's cache piece by
        the cache's names: the post-RoPE "k", "v"; MLA's "ckv", "krope"; a Mamba
        branch's "conv" (the last K − 1 pre-conv inputs) and "ssm" (h_T); the
        cross attention's unrotated "xk", "xv". Under ``rules`` the layer's input
        is sequence-parallel (dp, sp), and each normed input is gathered whole on
        the sequence before its projections (Megatron's sequence parallelism)."""
        x = constrain(x, rules, "dp", "sp", None)
        h = _whole_seq(self.norm1(x, cfg.norm_eps), rules)
        piece = {}
        if self.attn is None:
            s = ssm_lib.mamba_forward(self.mamba, h, chunk=plan.ssm_chunk, return_state=return_kv,
                                      **self._ssm_args(cfg))
            if return_kv:
                s, (piece["conv"], piece["ssm"]) = s
                return x + constrain(s, rules, "dp", "sp", None), None, piece
            return x + constrain(s, rules, "dp", "sp", None), None
        fwd, names = (attention.mla_forward, ("ckv", "krope")) if cfg.mla else (
            functools.partial(attention.gqa_forward, window=window), ("k", "v"))
        a = fwd(self.attn, h, rope_theta=cfg.rope_theta, chunk=plan.attn_chunk, return_kv=return_kv, rules=rules,
                **self._attn_args(cfg))
        if return_kv:
            a, kv = a
            piece.update(zip(names, kv))
        if self.mamba is not None:
            s = ssm_lib.mamba_forward(self.mamba, h, chunk=plan.ssm_chunk, return_state=return_kv,
                                      **self._ssm_args(cfg))
            if return_kv:
                s, (piece["conv"], piece["ssm"]) = s
            # Whole on the sequence, so that the scan's products take their gradient so placed.
            a = self.fuse(a, constrain(s, rules, "dp", None, None), cfg.norm_eps)
        x = x + constrain(a, rules, "dp", "sp", None)
        if self.xattn is not None:
            xa = attention.gqa_forward(self.xattn, _whole_seq(self.norm_x(x, cfg.norm_eps), rules), heads=cfg.num_heads,
                                       kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
                                       rope_theta=cfg.rope_theta, causal=False, chunk=plan.attn_chunk,
                                       kv_source=enc_out, return_kv=return_kv, rules=rules)
            if return_kv:
                xa, (piece["xk"], piece["xv"]) = xa
            x = x + constrain(xa, rules, "dp", "sp", None)
        f, aux = self._ffn(_whole_seq(self.norm2(x, cfg.norm_eps), rules), cfg, rules)
        return (x + f, aux, piece) if return_kv else (x + f, aux)

    def decode(self, x: torch.Tensor, lc: Dict[str, torch.Tensor], tables, cfg: ArchConfig, rules=None) -> torch.Tensor:
        """One token (B, 1, d) against this layer's cache views ``lc``
        (:func:`layer_caches`), written in place (the cross "xk" and "xv" only
        read); ``tables`` is ``attention.decode_tables`` of the position for the
        attention's cache."""
        h = self.norm1(x, cfg.norm_eps)
        if self.attn is None:
            s, conv, state = ssm_lib.mamba_decode(self.mamba, h, lc["conv"], lc["ssm"], **self._ssm_args(cfg))
            sharding.copy_into(lc["conv"], conv)
            sharding.copy_into(lc["ssm"], state)
            return x + s
        if cfg.mla:
            a = attention.mla_decode(self.attn, h, lc["ckv"], lc["krope"], tables, rules=rules,
                                     **self._attn_args(cfg))
        else:
            a = attention.gqa_decode(self.attn, h, lc["k"], lc["v"], tables, rules=rules, **self._attn_args(cfg))
        if self.mamba is not None:
            s, conv, state = ssm_lib.mamba_decode(self.mamba, h, lc["conv"], lc["ssm"], **self._ssm_args(cfg))
            sharding.copy_into(lc["conv"], conv)
            sharding.copy_into(lc["ssm"], state)
            a = self.fuse(a, s, cfg.norm_eps)
        x = x + a
        if self.xattn is not None:
            x = x + attention.cross_decode(self.xattn, self.norm_x(x, cfg.norm_eps), lc["xk"], lc["xv"],
                                           heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
                                           head_dim=cfg.resolved_head_dim, rules=rules)
        B, d = x.shape[0], x.shape[2]
        f, _ = self._ffn(self.norm2(x, cfg.norm_eps).reshape(1, B, d), cfg)  # the batch is the MoE group
        return x + f.reshape(B, 1, d)


class EncoderLayer(nn.Module):
    """One pre-norm encoder layer (whisper's frame encoder): x + attn(norm1(x)),
    bidirectional and without positions, then + ffn(norm2(·)), a SwiGLU."""

    def __init__(self, norm1: layers.RMSNorm, attn: attention.GQA, norm2: layers.RMSNorm, ffn: layers.SwiGLU):
        super().__init__()
        self.norm1, self.attn, self.norm2, self.ffn = norm1, attn, norm2, ffn

    def forward(self, x: torch.Tensor, cfg: ArchConfig, plan: ExecPlan, rules=None) -> torch.Tensor:
        x = constrain(x, rules, "dp", None, None)
        h = self.norm1(x, cfg.norm_eps)
        a = attention.gqa_forward(self.attn, h, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
                                  head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta, causal=False,
                                  chunk=plan.attn_chunk, rules=rules)
        x = x + constrain(a, rules, "dp", None, None)
        return x + constrain(self.ffn(self.norm2(x, cfg.norm_eps)), rules, "dp", None, None)


class VitProj(nn.Module):
    """The VLM's projection of patch embeddings into the model: w (vit_dim, d)."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = layers._param(w)


class LM(nn.Module):
    """A decoder LM: ``embed``, ``layers`` (an ``nn.ModuleList``), ``final_norm``
    and ``unembed`` (None when the embedding is tied); an encoder-decoder's
    ``enc_layers`` (an ``nn.ModuleList`` of :class:`EncoderLayer`) and
    ``enc_norm``, a VLM's ``vit_proj`` (None elsewhere). Its state dict's names
    follow the reference's tree: ``embed.table``, ``layers.<l>.attn.wq`` (MLA:
    ``.attn.w_dkv`` and so on), ``layers.<l>.ffn.w_gate`` (or
    ``layers.<l>.moe.router``, ``.moe.w_gate``), ``layers.<l>.mamba.in_proj``,
    ``layers.<l>.fuse.norm_a.scale``, ``layers.<l>.norm_x.scale``,
    ``layers.<l>.xattn.wk``, ``final_norm.scale``, ``unembed.w``,
    ``enc_layers.<l>.attn.wq``, ``enc_norm.scale``, ``vit_proj.w``."""

    def __init__(self, cfg: ArchConfig, embed: layers.Embedding, decoder_layers, final_norm: layers.RMSNorm,
                 unembed: Optional[layers.Unembed], *, enc_layers=None, enc_norm: Optional[layers.RMSNorm] = None,
                 vit_proj: Optional[VitProj] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = embed
        self.layers = nn.ModuleList(decoder_layers)
        self.final_norm = final_norm
        self.unembed = unembed
        self.enc_layers = None if enc_layers is None else nn.ModuleList(enc_layers)
        self.enc_norm = enc_norm
        self.vit_proj = vit_proj

    def unembed_w(self) -> torch.Tensor:
        """The (d, V_pad) unembedding: the tied table's transpose or ``unembed.w``."""
        return self.embed.table.T if self.cfg.tie_embeddings else self.unembed.w


# ===================================================================== init


def _init_mamba(key: torch.Tensor, cfg: ArchConfig, dtype: torch.dtype, device) -> ssm_lib.Mamba:
    return ssm_lib.init_mamba(key, cfg.d_model, d_inner=cfg.d_inner, state=cfg.ssm_state, d_conv=cfg.d_conv,
                              dt_rank=cfg.resolved_dt_rank, dtype=dtype, device=device)


def _init_layer(key: torch.Tensor, cfg: ArchConfig, dtype: torch.dtype, device) -> DecoderLayer:
    # The reference's per-layer split: attn ks[0], a hybrid's mamba ks[1], xattn ks[2], ffn or moe ks[3]; the
    # attention-free layer's mamba ks[0].
    ks = prng.split(key, 8)
    d = cfg.d_model
    if cfg.is_attention_free:
        return DecoderLayer(layers.init_rmsnorm(d, dtype, device), None, None, None,
                            mamba=_init_mamba(ks[0], cfg, dtype, device))
    if cfg.mla:
        attn = attention.init_mla(ks[0], d, cfg.num_heads, q_lora=cfg.q_lora_rank, kv_lora=cfg.kv_lora_rank,
                                  nope=cfg.qk_nope_dim, rope_d=cfg.qk_rope_dim, v_dim=cfg.v_head_dim, dtype=dtype,
                                  device=device)
    else:
        attn = attention.init_gqa(ks[0], d, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, dtype, device)
    mamba = fuse = None
    if cfg.hybrid:
        mamba = _init_mamba(ks[1], cfg, dtype, device)
        half = lambda: torch.full((d,), 0.5, dtype=dtype, device=device)
        fuse = Fuse(layers.init_rmsnorm(d, dtype, device), layers.init_rmsnorm(d, dtype, device), half(), half())
    norm_x = xattn = None
    if cfg.encdec:
        norm_x = layers.init_rmsnorm(d, dtype, device)
        xattn = attention.init_gqa(ks[2], d, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, dtype, device)
    if cfg.moe:
        ffn = moe_lib.init_moe(ks[3], d, cfg.d_ff, cfg.num_experts, dtype, device)
    else:
        ffn = layers.init_swiglu(ks[3], d, cfg.d_ff, dtype, device)
    return DecoderLayer(layers.init_rmsnorm(d, dtype, device), attn, layers.init_rmsnorm(d, dtype, device), ffn,
                        mamba=mamba, fuse=fuse, norm_x=norm_x, xattn=xattn)


def _init_enc_layer(key: torch.Tensor, cfg: ArchConfig, dtype: torch.dtype, device) -> EncoderLayer:
    # The reference's split: attn ks[0], ffn ks[1].
    ks = prng.split(key, 2)
    d = cfg.d_model
    return EncoderLayer(
        layers.init_rmsnorm(d, dtype, device),
        attention.init_gqa(ks[0], d, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, dtype, device),
        layers.init_rmsnorm(d, dtype, device),
        layers.init_swiglu(ks[1], d, cfg.d_ff, dtype, device),
    )


@torch.no_grad()
def init_params(cfg: ArchConfig, key: torch.Tensor, *, device=None) -> LM:
    """The model with the reference's weights for ``key``: every leaf is drawn from
    the reference's key tree (``split(key, 6)``; layer l from
    ``split(k_layers, L)[l]``, which is what the reference's vmap over layer keys
    draws; encoder layer l from ``split(k_enc, enc_layers)[l]``) by
    ``prng.normal``, scaled in float32 and rounded to the config's dtype, leaf
    by leaf on ``device`` (default CUDA). ``vit_proj.w`` is the one leaf the
    reference divides, normal(k_vit) / √vit_dim, and so is it here."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    d = cfg.d_model
    k_emb, k_layers, _, k_un, k_enc, k_vit = prng.split(key, 6)
    layer_keys = prng.split(k_layers, cfg.num_layers)
    enc = {}
    if cfg.encdec:
        enc_keys = prng.split(k_enc, cfg.enc_layers)
        enc = {"enc_layers": [_init_enc_layer(enc_keys[l], cfg, dtype, dev) for l in range(cfg.enc_layers)],
               "enc_norm": layers.init_rmsnorm(d, dtype, dev)}
    if cfg.vlm:
        enc["vit_proj"] = VitProj(layers.draw_normal(k_vit, (cfg.vit_dim, d), math.sqrt(cfg.vit_dim), dtype, dev,
                                                     divide=True))
    return LM(
        cfg,
        layers.init_embedding(k_emb, cfg.padded_vocab, d, dtype, dev),
        [_init_layer(layer_keys[l], cfg, dtype, dev) for l in range(cfg.num_layers)],
        layers.init_rmsnorm(d, dtype, dev),
        None if cfg.tie_embeddings else layers.init_unembed(k_un, d, cfg.padded_vocab, dtype, dev),
        **enc,
    )


def _gqa_shapes(cfg: ArchConfig, p: str) -> Dict[str, tuple]:
    d, qd, kvd = cfg.d_model, cfg.num_heads * cfg.resolved_head_dim, cfg.num_kv_heads * cfg.resolved_head_dim
    return {f"{p}.wq": (d, qd), f"{p}.wk": (d, kvd), f"{p}.wv": (d, kvd), f"{p}.wo": (qd, d)}


def _swiglu_shapes(cfg: ArchConfig, p: str) -> Dict[str, tuple]:
    d, f = cfg.d_model, cfg.d_ff
    return {f"{p}.w_gate": (d, f), f"{p}.w_up": (d, f), f"{p}.w_down": (f, d)}


def _layer_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    """A decoder layer's leaves by their names in the layer."""
    d, f = cfg.d_model, cfg.d_ff
    shapes = {"norm1.scale": (d,)}
    if cfg.hybrid or cfg.is_attention_free:
        C, N, r, K = cfg.d_inner, cfg.ssm_state, cfg.resolved_dt_rank, cfg.d_conv
        shapes.update({"mamba.in_proj": (d, 2 * C), "mamba.conv_w": (K, C), "mamba.conv_b": (C,),
                       "mamba.x_proj": (C, r + 2 * N), "mamba.dt_proj_w": (r, C), "mamba.dt_proj_b": (C,),
                       "mamba.A_log": (C, N), "mamba.D": (C,), "mamba.out_proj": (C, d)})
    if cfg.is_attention_free:
        return shapes
    H = cfg.num_heads
    if cfg.mla:
        nope, rope_d, v = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        shapes.update({"attn.w_dq": (d, cfg.q_lora_rank), "attn.w_uq": (cfg.q_lora_rank, H * (nope + rope_d)),
                       "attn.w_dkv": (d, cfg.kv_lora_rank + rope_d), "attn.w_ukv": (cfg.kv_lora_rank, H * (nope + v)),
                       "attn.wo": (H * v, d)})
    else:
        shapes.update(_gqa_shapes(cfg, "attn"))
    if cfg.hybrid:
        shapes.update({"fuse.norm_a.scale": (d,), "fuse.norm_s.scale": (d,), "fuse.beta_a": (d,), "fuse.beta_s": (d,)})
    if cfg.encdec:
        shapes.update({"norm_x.scale": (d,), **_gqa_shapes(cfg, "xattn")})
    shapes["norm2.scale"] = (d,)
    if cfg.moe:
        E = cfg.num_experts
        shapes.update({"moe.router": (d, E), "moe.w_gate": (E, d, f), "moe.w_up": (E, d, f),
                       "moe.w_down": (E, f, d)})
    else:
        shapes.update(_swiglu_shapes(cfg, "ffn"))
    return shapes


def _leaf_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    """Each state-dict leaf's shape by name; a layer's leaves by their stack and
    their name in the layer, without the layer's index (``layers.attn.wq``,
    ``enc_layers.ffn.w_up``)."""
    d, V = cfg.d_model, cfg.padded_vocab
    shapes = {"embed.table": (V, d), "final_norm.scale": (d,)}
    shapes.update({f"layers.{n}": s for n, s in _layer_shapes(cfg).items()})
    if not cfg.tie_embeddings:
        shapes["unembed.w"] = (d, V)
    if cfg.encdec:
        shapes.update({"enc_layers.norm1.scale": (d,), **_gqa_shapes(cfg, "enc_layers.attn"),
                       "enc_layers.norm2.scale": (d,), **_swiglu_shapes(cfg, "enc_layers.ffn"),
                       "enc_norm.scale": (d,)})
    if cfg.vlm:
        shapes["vit_proj.w"] = (cfg.vit_dim, d)
    return shapes


def leaf_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """A leaf's dtype in a model of ``dtype``: the config's, but a Mamba block's
    ``A_log``, which is float32 in every model."""
    return torch.float32 if name.endswith("A_log") else dtype


def _indexed(name: str, l: int) -> str:
    """A stacked leaf's state-dict name: ``layers.attn.wq`` of layer 3 is ``layers.3.attn.wq``."""
    stack, rest = name.split(".", 1)
    return f"{stack}.{l}.{rest}"


def _assemble(cfg: ArchConfig, leaf) -> LM:
    """An LM from ``leaf(name, l)``: the tensor of leaf ``name`` (a
    :func:`_leaf_shapes` name; ``l`` the layer's index in its stack, or None
    outside the stacks)."""
    def gqa(g, p):
        return attention.GQA(g(f"{p}.wq"), g(f"{p}.wk"), g(f"{p}.wv"), g(f"{p}.wo"))

    def layer(l):
        g = lambda n: leaf(f"layers.{n}", l)
        mamba = lambda: ssm_lib.Mamba(**{n: g(f"mamba.{n}") for n in ssm_lib.Mamba.LEAVES})
        if cfg.is_attention_free:
            return DecoderLayer(layers.RMSNorm(g("norm1.scale")), None, None, None, mamba=mamba())
        attn = attention.MLA(**{n: g(f"attn.{n}") for n in attention.MLA.LEAVES}) if cfg.mla else gqa(g, "attn")
        branch = fuse = norm_x = xattn = None
        if cfg.hybrid:
            branch = mamba()
            fuse = Fuse(layers.RMSNorm(g("fuse.norm_a.scale")), layers.RMSNorm(g("fuse.norm_s.scale")),
                        g("fuse.beta_a"), g("fuse.beta_s"))
        if cfg.encdec:
            norm_x, xattn = layers.RMSNorm(g("norm_x.scale")), gqa(g, "xattn")
        if cfg.moe:
            ffn = moe_lib.MoE(g("moe.router"), g("moe.w_gate"), g("moe.w_up"), g("moe.w_down"))
        else:
            ffn = layers.SwiGLU(g("ffn.w_gate"), g("ffn.w_up"), g("ffn.w_down"))
        return DecoderLayer(layers.RMSNorm(g("norm1.scale")), attn, layers.RMSNorm(g("norm2.scale")), ffn,
                            mamba=branch, fuse=fuse, norm_x=norm_x, xattn=xattn)

    def enc_layer(l):
        g = lambda n: leaf(f"enc_layers.{n}", l)
        return EncoderLayer(layers.RMSNorm(g("norm1.scale")), gqa(g, "attn"), layers.RMSNorm(g("norm2.scale")),
                            layers.SwiGLU(g("ffn.w_gate"), g("ffn.w_up"), g("ffn.w_down")))

    extra = {}
    if cfg.encdec:
        extra = {"enc_layers": [enc_layer(l) for l in range(cfg.enc_layers)],
                 "enc_norm": layers.RMSNorm(leaf("enc_norm.scale", None))}
    if cfg.vlm:
        extra["vit_proj"] = VitProj(leaf("vit_proj.w", None))
    return LM(cfg, layers.Embedding(leaf("embed.table", None)), [layer(l) for l in range(cfg.num_layers)],
              layers.RMSNorm(leaf("final_norm.scale", None)),
              None if cfg.tie_embeddings else layers.Unembed(leaf("unembed.w", None)), **extra)


def meta_params(cfg: ArchConfig) -> LM:
    """The model assembled from ``meta`` tensors: every shape and dtype, nothing
    allocated."""
    check_supported(cfg)
    shapes, dtype = _leaf_shapes(cfg), torch_dtype(cfg)
    return _assemble(cfg, lambda name, l: torch.empty(shapes[name], dtype=leaf_dtype(name, dtype), device="meta"))


def param_shapes(cfg: ArchConfig) -> Dict[str, torch.Size]:
    """Every parameter's shape by state-dict name, without allocating."""
    return {name: p.shape for name, p in meta_params(cfg).state_dict().items()}


def params_from_named(cfg: ArchConfig, named: Dict[str, torch.Tensor]) -> LM:
    """The model holding ``named``'s tensors (by state-dict name) as they are."""
    check_supported(cfg)
    return _assemble(cfg, lambda name, l: named[name if l is None else _indexed(name, l)])


@torch.no_grad()
def params_from_reference(cfg: ArchConfig, tree, *, device=None) -> LM:
    """The model holding the reference's parameter tree ``tree`` (numpy arrays or
    anything ``np.asarray`` takes; the leaves of ``layers`` and ``enc_layers``
    stacked on a leading L axis, as ``repro.models.lm.init_params`` makes them),
    in the config's dtype (``A_log`` float32) on ``device`` (default CUDA).
    bfloat16 leaves convert exactly."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)

    def leaf(name: str, l: Optional[int]):
        node = tree
        for part in name.split("."):
            node = node[part]
        t = torch.from_numpy(np.array(node if l is None else node[l], dtype=np.float32))
        return t.to(device=dev, dtype=leaf_dtype(name, dtype))

    return _assemble(cfg, leaf)


# ===================================================================== forward (prefill)


def embed_inputs(params: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *, rules=None,
                 plan: ExecPlan = ExecPlan()) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Token embedding and the frontend stubs. Returns (x (B, S, d), loss_mask
    (B, S) float32, enc_out (B, enc_seq, d) or None).

    A VLM's ``batch["patches"]`` (B, P, vit_dim), cast to the model dtype and
    projected by ``vit_proj``, take the place of the first P positions, whose
    loss mask is zeroed. Where the prompt rectangle is shorter than the patches
    (S < P) the reference's x would have P positions against S tokens: that is
    refused (``ValueError``), a guard, not a feature. An encoder-decoder's
    ``batch["frames"]`` (B, enc_seq, d) go through ``encoder_forward``."""
    tokens = batch["tokens"]
    x = params.embed(tokens)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32, device=x.device)
    enc_out = None
    if cfg.vlm and "patches" in batch:
        proj = batch["patches"].to(device=x.device, dtype=x.dtype) @ params.vit_proj.w
        B, P, S = x.shape[0], proj.shape[1], x.shape[1]
        if S < P:
            raise ValueError(f"{P} patches do not fit a prompt of {S} positions: the patches take the first "
                             f"{P} positions of the token rectangle")
        x = torch.cat([proj, x[:, P:]], dim=1)
        mask = torch.cat([torch.zeros((B, P), dtype=torch.float32, device=x.device), mask.to(x.device)[:, P:]], dim=1)
    if cfg.encdec and "frames" in batch:
        enc_out = encoder_forward(params, cfg, batch["frames"].to(x.device), rules=rules, plan=plan)
    return x, mask, enc_out


def encoder_forward(params: LM, cfg: ArchConfig, frames: torch.Tensor, *, rules=None,
                    plan: ExecPlan = ExecPlan()) -> torch.Tensor:
    """The bidirectional encoder over precomputed frame embeddings (whisper's
    stub), cast to the model dtype first: ``enc_layers`` in order, each
    rematerialized where autograd records (the reference checkpoints every
    encoder layer), then ``enc_norm``. (B, enc_seq, d) -> (B, enc_seq, d)."""
    x = frames.to(torch_dtype(cfg))
    for layer in params.enc_layers:
        x = _remat(lambda x, layer=layer: layer(x, cfg, plan, rules), "full", x)
    return params.enc_norm(x, cfg.norm_eps)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of weight products (the reference's
    ``checkpoint_dots_with_no_batch_dims``: attention's batched products and
    everything else are recomputed)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str, *args):
    """``fn(*args)`` under the plan's rematerialization when autograd records."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils import checkpoint as ckpt

    if remat == "full":
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               context_fn=lambda: ckpt.create_selective_checkpoint_contexts(_dots_policy))
    raise ValueError(f"remat must be none, full or dots, not {remat!r}")


def trunk(params: LM, cfg: ArchConfig, x: torch.Tensor, *, rules=None, enc_out: Optional[torch.Tensor] = None,
          plan: ExecPlan = ExecPlan()) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layers over x: (B, S, d), each under ``plan.remat``, the cross
    attention reading ``enc_out``. Returns (the final-norm hidden states, the
    MoE aux loss summed over the layers in float32; 0 for a dense model)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, window in zip(params.layers, layer_windows(cfg).tolist()):
        x, a = _remat(lambda x, layer=layer, window=window: layer(x, cfg, window, plan, enc_out=enc_out, rules=rules),
                      plan.remat, x)
        if a is not None:
            aux = aux + a
    return params.final_norm(x, cfg.norm_eps), aux


@_inference
def forward_logits(params: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *, rules=None,
                   plan: ExecPlan = ExecPlan()) -> torch.Tensor:
    """Full (B, S, V_pad) float32 logits (no chunking over the sequence)."""
    x, _, enc_out = embed_inputs(params, cfg, batch, rules=rules, plan=plan)
    h = _whole_seq(trunk(params, cfg, x, rules=rules, enc_out=enc_out, plan=plan)[0], rules)
    return layers.unembed(params.unembed_w(), h).to(torch.float32)


# ===================================================================== loss


def _ce_chunk(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, rules=None):
    """(Σ masked nll, Σ mask) of one chunk: logits in h's dtype, then float32
    (vocab-sharded under ``rules``)."""
    logits = constrain((h @ w).to(torch.float32), rules, "dp", None, "tensor")
    logz = torch.logsumexp(logits, dim=-1)
    ids = labels.to(torch.int64)[..., None]
    if is_sharded(logits):
        hit = ids == torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.sum(torch.where(hit, logits, 0.0), dim=-1)
    else:
        gold = torch.gather(logits, -1, ids)[..., 0]
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def chunked_ce_loss(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, *,
                    chunk: int = 512, rules=None) -> torch.Tensor:
    """Masked mean next-token CE of hidden states h (B, S, d) against the (d, V)
    unembedding w, without (B, S, V) logits: the sequence in chunks of
    ``chunk``, each chunk's logits made, reduced to two float32 sums and
    dropped (checkpointed, so the backward pass makes them again). The last
    chunk is shorter where the reference pads with masked zeros."""
    S = h.shape[1]
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    mask = mask.to(torch.float32)
    for j in range(0, S, chunk):
        args = (h[:, j : j + chunk], w, labels[:, j : j + chunk], mask[:, j : j + chunk], rules)
        if torch.is_grad_enabled():
            from torch.utils import checkpoint as ckpt

            nll, m = ckpt.checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            nll, m = _ce_chunk(*args)
        tot, cnt = tot + nll, cnt + m
    return tot / torch.clamp_min(cnt, 1.0)


def lm_loss(params: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *, rules=None,
            plan: ExecPlan = ExecPlan()) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token CE (position t predicts token t + 1) + the MoE aux loss,
    and {"ce", "moe_aux"}: the single entry point of training. A sharded
    model's backward pass runs inside :func:`sharded_region` too."""
    with sharded_region(params):
        x, mask, enc_out = embed_inputs(params, cfg, batch, rules=rules, plan=plan)
        h, aux = trunk(params, cfg, x, rules=rules, enc_out=enc_out, plan=plan)
        h = _whole_seq(h, rules)
        labels = batch["labels"].to(h.device)
        ce = chunked_ce_loss(h[:, :-1], params.unembed_w(), labels[:, 1:], mask[:, 1:].to(h.device),
                             chunk=plan.loss_chunk, rules=rules)
        return ce + cfg.router_aux_coef * aux, {"ce": ce, "moe_aux": aux}


# ===================================================================== KV cache


def _local_global(cfg: ArchConfig) -> bool:
    return cfg.attn_kind == "local_global" and cfg.local_global_ratio > 0


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *, dtype: Optional[torch.dtype] = None,
               device=None) -> dict:
    """Decode cache for ``seq_len`` positions, zeros in the config's dtype on
    ``device`` (default CUDA): {"k", "v"}, each (L, batch, S_c, KV, hd) with S_c
    = seq_len, or min(window, seq_len) for sliding-window attention; for the
    local:global pattern {"local": {"k", "v"}} of G·R rings of min(window,
    seq_len) and {"global": {"k", "v"}} of G caches of seq_len (G = L // (R + 1));
    for MLA {"ckv" (L, batch, seq_len, kv_lora), "krope" (…, rope_d)}; for the
    hybrid's Mamba branch, beside its ring, "conv" (L, batch, K − 1, C) and
    "ssm" (L, batch, C, N), the latter float32 always, and for the
    attention-free stack those two alone; for the encoder-decoder, beside "k"
    and "v", "xk" and "xv" (L, batch, enc_seq, KV, hd)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(cfg)
    L = cfg.num_layers
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)
    mamba = lambda: {"conv": zeros(L, batch, cfg.d_conv - 1, cfg.d_inner),
                     "ssm": zeros(L, batch, cfg.d_inner, cfg.ssm_state, dt=torch.float32)}
    if cfg.is_attention_free:
        return mamba()

    def kv(n: int, s: int) -> Dict[str, torch.Tensor]:
        shape = (n, batch, s, cfg.num_kv_heads, cfg.resolved_head_dim)
        return {"k": zeros(*shape), "v": zeros(*shape)}

    if cfg.mla:
        cache = {"ckv": zeros(L, batch, seq_len, cfg.kv_lora_rank), "krope": zeros(L, batch, seq_len, cfg.qk_rope_dim)}
    elif _local_global(cfg):
        R = cfg.local_global_ratio
        groups = L // (R + 1)
        cache = {"local": kv(groups * R, min(cfg.window, seq_len)), "global": kv(groups, seq_len)}
    else:
        swa = cfg.attn_kind == "swa" and cfg.window > 0
        cache = kv(L, min(cfg.window, seq_len) if swa else seq_len)
    if cfg.hybrid:
        cache.update(mamba())
    if cfg.encdec:
        cross = (L, batch, cfg.enc_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        cache.update(xk=zeros(*cross), xv=zeros(*cross))
    return cache


def cache_shapes(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """:func:`init_cache`'s tree as ``meta`` tensors: every shape and dtype,
    nothing allocated."""
    return init_cache(cfg, batch, seq_len, device="meta")


def sharded_cache(cfg: ArchConfig, batch: int, seq_len: int, mesh, rules, *, batch_sharded: bool = True,
                  device=None) -> dict:
    """:func:`init_cache`'s zeros as DTensors on ``mesh``, placed by the
    reference's ``cache_pspecs``, each rank allocating its own shard on
    ``device`` (``meta`` for the dry run)."""
    if rules is None:
        raise ValueError("a sharded cache is placed by the sharding rules; pass rules=")
    shapes = cache_shapes(cfg, batch, seq_len)
    specs = sharding.cache_pspecs(shapes, rules, batch_sharded=batch_sharded)
    return sharding.map_specs(
        lambda spec, t: sharding.zeros(t.shape, t.dtype, mesh, sharding.to_placements(spec, mesh), device), specs,
        shapes)


def layer_caches(cfg: ArchConfig, cache: dict) -> List[Dict[str, torch.Tensor]]:
    """Each decoded layer's cache views by name ("k", "v"; "ckv", "krope";
    "conv", "ssm"; "xk", "xv"), layer l's entry of each leaf. With the local:global split,
    layer l = g·(R + 1) + r reads local entry g·R + r (r < R) or global entry
    g; the reference's grouped decode covers the G whole groups, so the list
    has G·(R + 1) entries."""
    stacked = {n: t for n, t in cache.items() if not isinstance(t, dict)}
    if not _local_global(cfg):
        return [{n: t[l] for n, t in stacked.items()} for l in range(next(iter(stacked.values())).shape[0])]
    R = cfg.local_global_ratio
    out = []
    for l in range(cache["global"]["k"].shape[0] * (R + 1)):
        g, r = divmod(l, R + 1)
        part, i = (cache["local"], g * R + r) if r < R else (cache["global"], g)
        out.append({"k": part["k"][i], "v": part["v"][i], **{n: t[l] for n, t in stacked.items()}})
    return out


# ===================================================================== decode


@_inference
def decode_step(params: LM, cfg: ArchConfig, tokens: torch.Tensor, cache: dict, pos: int, *, rules=None,
                x_embed: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
    """One-token decode at position ``pos`` (an int; the attention-free stack's
    recurrence does not read it). tokens: (B,) ids, or ``x_embed`` (B, d)
    pre-embedded inputs in their place. Writes each layer's k, v (MLA: c_kv,
    k_rope) into its ring of ``cache`` and its Mamba states over theirs, in
    place (``layer_caches``). Returns (logits (B, V_pad) float32, cache)."""
    x = params.embed(tokens[:, None]) if x_embed is None else x_embed[:, None, :]
    x = constrain(x, rules, "dp", None, None)
    rot = cfg.qk_rope_dim if cfg.mla else int(cfg.resolved_head_dim * cfg.rope_fraction) & ~1
    seq_leaf = "ckv" if cfg.mla else "k"
    tables = {}  # by ring length: the local rings and the global caches of gemma3
    for layer, lc in zip(params.layers, layer_caches(cfg, cache)):
        s_cache = lc[seq_leaf].shape[1] if seq_leaf in lc else None  # None: the attention-free stack
        if s_cache is not None and s_cache not in tables:
            tables[s_cache] = attention.decode_tables(int(pos), s_cache, rot, cfg.rope_theta, x.device)
        x = layer.decode(x, lc, tables.get(s_cache), cfg, rules)
    h = params.final_norm(x, cfg.norm_eps)
    return constrain(layers.unembed(params.unembed_w(), h)[:, 0].to(torch.float32), rules, "dp", "tensor"), cache


# ===================================================================== prefill


def _pad_seq(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Write (B, S, ...) ``src`` into the (B, cache_len, ...) cache ``dst`` as the
    reference's ``_pad_seq`` places it: at slots 0..S-1, or its last cache_len
    positions when S > cache_len."""
    S, cache_len = src.shape[1], dst.shape[1]
    if is_sharded(dst):
        first = max(S - cache_len, 0)
        sharding.write_slots(dst, src, list(range(S - first)), list(range(first, S)))
    elif S > cache_len:
        dst.copy_(src[:, S - cache_len :])
    else:
        dst[:, :S] = src


def _ring_place(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Write the last min(S_c, S) positions of (B, S, ...) ``src`` into the ring
    (B, S_c, ...) ``dst`` at slots p mod S_c (the reference's ``_ring_place``;
    the other slots stay zero)."""
    S, s_cache = src.shape[1], dst.shape[1]
    take = min(s_cache, S)
    if is_sharded(dst):
        sharding.write_slots(dst, src, [p % s_cache for p in range(S - take, S)], list(range(S - take, S)))
        return
    slots = torch.arange(S - take, S, device=dst.device) % s_cache
    dst[:, slots] = src[:, S - take :]


@_inference
def batched_prefill(params: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *, cache_len: Optional[int] = None,
                    rules=None, plan: ExecPlan = ExecPlan()) -> Tuple[torch.Tensor, dict]:
    """Flash prefill: one batched pass over the prompt. Returns (last-token logits
    (B, V_pad) float32, a decode cache of ``cache_len`` positions (default S)
    positioned at pos = S). A windowed layer's k, v go to its ring at slots
    p mod S_c (``_ring_place``), a full layer's (and MLA's latent) to slots
    0…S−1 (``_pad_seq``); a Mamba branch's conv tail and h_T are its states, and
    the cross keys and values over the encoder's output (``batch["frames"]``)
    are copied whole: enc_seq entries, neither a ring nor padded."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x, _, enc_out = embed_inputs(params, cfg, batch, rules=rules, plan=plan)
    cache = (sharded_cache(cfg, B, cache_len or S, x.device_mesh, rules, device=x.to_local().device)
             if is_sharded(x) else init_cache(cfg, B, cache_len or S, device=x.device))
    slots = layer_caches(cfg, cache)
    for l, (layer, window) in enumerate(zip(params.layers, layer_windows(cfg).tolist())):
        x, _, piece = layer(x, cfg, window, plan, return_kv=True, enc_out=enc_out, rules=rules)
        if l < len(slots):
            for name, t in piece.items():
                if name in ("conv", "ssm", "xk", "xv"):
                    sharding.copy_into(slots[l][name], t)
                else:
                    (_ring_place if window > 0 else _pad_seq)(slots[l][name], t)
    h = params.final_norm(_whole_seq(x, rules)[:, -1:], cfg.norm_eps)
    return constrain(layers.unembed(params.unembed_w(), h)[:, 0].to(torch.float32), rules, "dp", "tensor"), cache


@_inference
def prefill(params: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor], cache: dict, *,
            rules=None) -> Tuple[torch.Tensor, dict]:
    """Fill the cache from a prompt by stepping ``decode_step`` over its positions
    (one code path for the cache's semantics). An encoder-decoder's frames go
    through the encoder once, up front, and every layer's cross keys and values
    are its ``xattn.wk`` and ``wv`` of that output, in the model dtype, written
    to ``cache["xk"]`` and ``["xv"]``; a VLM's patches are embedded before the
    loop, so position i's input is the batched path's. Returns (the last
    position's logits (B, V_pad) float32, cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if cfg.encdec and "frames" in batch:
        enc_out = encoder_forward(params, cfg, batch["frames"].to(cache["xk"].device), rules=rules)
        shape = (B, cfg.enc_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        for l, layer in enumerate(params.layers):
            cache["xk"][l] = (enc_out @ layer.xattn.wk).reshape(shape).to(cache["xk"].dtype)
            cache["xv"][l] = (enc_out @ layer.xattn.wv).reshape(shape).to(cache["xv"].dtype)
    x_all, _, _ = embed_inputs(params, cfg, {k: v for k, v in batch.items() if k != "frames"}, rules=rules)
    logits = torch.zeros((B, cfg.padded_vocab), dtype=torch.float32, device=x_all.device)
    for i in range(S):
        logits, cache = decode_step(params, cfg, tokens[:, i], cache, i, rules=rules, x_embed=x_all[:, i])
    return logits, cache
