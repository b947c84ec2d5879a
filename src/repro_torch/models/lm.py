"""The decoder LM of the port: parameters, forward, KV cache, decode and prefill.

Port of ``repro.models.lm`` for the dense decoder family (full attention, GQA,
SwiGLU, RMSNorm, RoPE at any ``rope_fraction``: granite-3-8b, chatglm3-6b). A
model is an :class:`LM` module: the embedding, an ``nn.ModuleList`` of
:class:`DecoderLayer` looped in Python, the final norm and the unembedding.
Weights keep the reference's (in, out) orientation; the functions mirror the
reference's (``forward_logits(params, cfg, batch)`` and so on) with ``params``
the module. Inference runs under ``torch.inference_mode()``.

Training (``lm_loss``) differentiates the same forward: ``trunk`` wraps each
layer in ``torch.utils.checkpoint`` by ``ExecPlan.remat`` (``full``: only the
layer's input is kept; ``dots``: the outputs of the weight products are kept,
the rest recomputed; the reference's ``jax.checkpoint`` policies), and the
next-token loss is chunked over the sequence with each chunk's logits
recomputed in the backward pass, so (B, S, V) logits never exist. The MoE
auxiliary loss is 0 until the MoE slice (ROADMAP item 9b).

The KV cache is a dict of two (L, B, max_len, KV, hd) tensors allocated once and
written in place; a full-attention cache is the reference's ring with one slot a
position. Configs of other families (MoE, MLA, SSM, hybrid, enc-dec, VLM,
sliding-window and local:global attention) raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

# Features of the reference's other families, each with the ROADMAP Queue 1 slice
# of item 9 that ports it.
_UNPORTED = (
    (lambda c: c.moe, "MoE (models/moe.py)", "9b"),
    (lambda c: c.attn_kind == "swa", "sliding-window attention", "9b"),
    (lambda c: c.attn_kind == "local_global", "local:global attention", "9b"),
    (lambda c: c.mla, "MLA", "9c"),
    (lambda c: c.family == "ssm", "the SSM family (models/ssm.py)", "9d"),
    (lambda c: c.hybrid or c.family == "hybrid", "the hybrid family", "9d"),
    (lambda c: c.encdec or c.family == "encdec", "the encoder-decoder family", "9e"),
    (lambda c: c.vlm or c.family == "vlm", "the VLM family", "9e"),
)


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config outside the ported dense family."""
    missing = [(what, item) for test, what, item in _UNPORTED if test(cfg)]
    if missing:
        parts = ", ".join(f"{what} (ROADMAP Queue 1 item {item})" for what, item in missing)
        raise NotImplementedError(f"{cfg.name} ({cfg.family}): {parts} is not ported to repro_torch yet; "
                                  "only the dense decoder family is")


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """Execution knobs, orthogonal to the architecture config."""

    attn_chunk: int = 1024      # flash key-chunk: attention's memory is O(S·attn_chunk)
    loss_chunk: int = 512       # CE vocab-matmul sequence chunk
    remat: str = "full"         # none | full | dots (applies where autograd records)


# ===================================================================== layer windows


def layer_windows(cfg: ArchConfig) -> torch.Tensor:
    """Per-layer attention window (int32 on the CPU, 0 = global/full): the gemma3
    pattern, mixtral's uniform SWA, or all zeros for full attention. Only the
    last is reachable in the port until ROADMAP Queue 1 item 9b ports those
    families (``check_supported`` refuses them first); the other two branches
    are held against the reference's by the tests."""
    if cfg.attn_kind == "local_global" and cfg.local_global_ratio > 0:
        idx = torch.arange(cfg.num_layers)
        return torch.where(idx % (cfg.local_global_ratio + 1) < cfg.local_global_ratio, cfg.window, 0).to(torch.int32)
    if cfg.attn_kind == "swa" and cfg.window > 0:
        return torch.full((cfg.num_layers,), cfg.window, dtype=torch.int32)
    return torch.zeros((cfg.num_layers,), dtype=torch.int32)


def cache_lengths(cfg: ArchConfig, seq_len: int) -> torch.Tensor:
    """Per-layer KV cache length: SWA layers keep a rolling ``window`` buffer. No
    path of the port calls it until item 9b (the dense family's caches are all
    ``seq_len``); the tests hold it against the reference's."""
    w = layer_windows(cfg)
    return torch.where(w > 0, torch.clamp_max(w, seq_len), seq_len)


# ===================================================================== modules


class DecoderLayer(nn.Module):
    """One pre-norm decoder layer: x + attn(norm1(x)), then + swiglu(norm2(·))."""

    def __init__(self, norm1: layers.RMSNorm, attn: attention.GQA, norm2: layers.RMSNorm, ffn: layers.SwiGLU):
        super().__init__()
        self.norm1, self.attn, self.norm2, self.ffn = norm1, attn, norm2, ffn

    def _attn_args(self, cfg: ArchConfig) -> dict:
        return dict(heads=cfg.num_heads, kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
                    rope_fraction=cfg.rope_fraction)

    def forward(self, x: torch.Tensor, cfg: ArchConfig, window: int, plan: ExecPlan, *, return_kv: bool = False):
        """(B, S, d) -> (B, S, d); with ``return_kv`` also this layer's post-RoPE (k, v)."""
        a = attention.gqa_forward(self.attn, self.norm1(x, cfg.norm_eps), rope_theta=cfg.rope_theta, window=window,
                                  chunk=plan.attn_chunk, return_kv=return_kv, **self._attn_args(cfg))
        kv = None
        if return_kv:
            a, kv = a
        x = x + a
        x = x + self.ffn(self.norm2(x, cfg.norm_eps))
        return (x, kv) if return_kv else x

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, tables, cfg: ArchConfig):
        """One token (B, 1, d) against this layer's cache (B, Sc, KV, hd), written in place."""
        x = x + attention.gqa_decode(self.attn, self.norm1(x, cfg.norm_eps), cache_k, cache_v, tables,
                                     **self._attn_args(cfg))
        return x + self.ffn(self.norm2(x, cfg.norm_eps))


class LM(nn.Module):
    """A dense decoder LM: ``embed``, ``layers`` (an ``nn.ModuleList``),
    ``final_norm`` and ``unembed`` (None when the embedding is tied). Its state
    dict's names follow the reference's tree: ``embed.table``,
    ``layers.<l>.attn.wq``, ``layers.<l>.ffn.w_gate``, ``final_norm.scale``,
    ``unembed.w``."""

    def __init__(self, cfg: ArchConfig, embed: layers.Embedding, decoder_layers, final_norm: layers.RMSNorm,
                 unembed: Optional[layers.Unembed]):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = embed
        self.layers = nn.ModuleList(decoder_layers)
        self.final_norm = final_norm
        self.unembed = unembed

    def unembed_w(self) -> torch.Tensor:
        """The (d, V_pad) unembedding: the tied table's transpose or ``unembed.w``."""
        return self.embed.table.T if self.cfg.tie_embeddings else self.unembed.w


# ===================================================================== init


def _init_layer(key: torch.Tensor, cfg: ArchConfig, dtype: torch.dtype, device) -> DecoderLayer:
    ks = prng.split(key, 8)  # the reference's per-layer split: attn ks[0], ffn ks[3]
    d = cfg.d_model
    return DecoderLayer(
        layers.init_rmsnorm(d, dtype, device),
        attention.init_gqa(ks[0], d, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, dtype, device),
        layers.init_rmsnorm(d, dtype, device),
        layers.init_swiglu(ks[3], d, cfg.d_ff, dtype, device),
    )


@torch.no_grad()
def init_params(cfg: ArchConfig, key: torch.Tensor, *, device=None) -> LM:
    """The model with the reference's weights for ``key``: every leaf is drawn from
    the reference's key tree (``split(key, 6)``; layer l from
    ``split(k_layers, L)[l]``, which is what the reference's vmap over layer keys
    draws) by ``prng.normal``, scaled in float32 and rounded to the config's
    dtype, leaf by leaf on ``device`` (default CUDA)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    k_emb, k_layers, _, k_un, _, _ = prng.split(key, 6)
    layer_keys = prng.split(k_layers, cfg.num_layers)
    return LM(
        cfg,
        layers.init_embedding(k_emb, cfg.padded_vocab, cfg.d_model, dtype, dev),
        [_init_layer(layer_keys[l], cfg, dtype, dev) for l in range(cfg.num_layers)],
        layers.init_rmsnorm(cfg.d_model, dtype, dev),
        None if cfg.tie_embeddings else layers.init_unembed(k_un, cfg.d_model, cfg.padded_vocab, dtype, dev),
    )


def _leaf_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    """Each state-dict leaf's shape; layer leaves without their ``layers.<l>.`` prefix."""
    d, f, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    qd, kvd = cfg.num_heads * cfg.resolved_head_dim, cfg.num_kv_heads * cfg.resolved_head_dim
    shapes = {"embed.table": (V, d), "norm1.scale": (d,), "attn.wq": (d, qd), "attn.wk": (d, kvd),
              "attn.wv": (d, kvd), "attn.wo": (qd, d), "norm2.scale": (d,), "ffn.w_gate": (d, f),
              "ffn.w_up": (d, f), "ffn.w_down": (f, d), "final_norm.scale": (d,)}
    if not cfg.tie_embeddings:
        shapes["unembed.w"] = (d, V)
    return shapes


def _assemble(cfg: ArchConfig, leaf) -> LM:
    """An LM from ``leaf(name, l)``: the tensor of leaf ``name`` (of layer l, or
    None outside the layers)."""
    def layer(l):
        g = lambda n: leaf(n, l)
        return DecoderLayer(layers.RMSNorm(g("norm1.scale")),
                            attention.GQA(g("attn.wq"), g("attn.wk"), g("attn.wv"), g("attn.wo")),
                            layers.RMSNorm(g("norm2.scale")),
                            layers.SwiGLU(g("ffn.w_gate"), g("ffn.w_up"), g("ffn.w_down")))

    return LM(cfg, layers.Embedding(leaf("embed.table", None)), [layer(l) for l in range(cfg.num_layers)],
              layers.RMSNorm(leaf("final_norm.scale", None)),
              None if cfg.tie_embeddings else layers.Unembed(leaf("unembed.w", None)))


def meta_params(cfg: ArchConfig) -> LM:
    """The model assembled from ``meta`` tensors: every shape and dtype, nothing
    allocated."""
    check_supported(cfg)
    shapes, dtype = _leaf_shapes(cfg), torch_dtype(cfg)
    return _assemble(cfg, lambda name, l: torch.empty(shapes[name], dtype=dtype, device="meta"))


def param_shapes(cfg: ArchConfig) -> Dict[str, torch.Size]:
    """Every parameter's shape by state-dict name, without allocating."""
    return {name: p.shape for name, p in meta_params(cfg).state_dict().items()}


def params_from_named(cfg: ArchConfig, named: Dict[str, torch.Tensor]) -> LM:
    """The model holding ``named``'s tensors (by state-dict name) as they are."""
    check_supported(cfg)
    return _assemble(cfg, lambda name, l: named[name if l is None else f"layers.{l}.{name}"])


@torch.no_grad()
def params_from_reference(cfg: ArchConfig, tree, *, device=None) -> LM:
    """The model holding the reference's parameter tree ``tree`` (numpy arrays or
    anything ``np.asarray`` takes; layer leaves stacked on a leading L axis, as
    ``repro.models.lm.init_params`` makes them), in the config's dtype on
    ``device`` (default CUDA). bfloat16 leaves convert exactly."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)

    def leaf(name: str, l: Optional[int]):
        mod, w = name.split(".")
        a = tree["layers"][mod][w][l] if l is not None else tree[mod][w]
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=dtype)

    return _assemble(cfg, leaf)


# ===================================================================== forward (prefill)


def embed_inputs(params: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embedding. Returns (x (B, S, d), loss_mask (B, S) float32)."""
    tokens = batch["tokens"]
    x = params.embed(tokens)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32, device=x.device)
    return x, mask


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


def trunk(params: LM, cfg: ArchConfig, x: torch.Tensor, *, plan: ExecPlan = ExecPlan()) -> torch.Tensor:
    """The layers over x: (B, S, d), each under ``plan.remat``. Returns the
    final-norm hidden states (the reference's MoE aux loss comes with the MoE
    slice)."""
    for layer, window in zip(params.layers, layer_windows(cfg).tolist()):
        x = _remat(lambda x, layer=layer, window=window: layer(x, cfg, window, plan), plan.remat, x)
    return params.final_norm(x, cfg.norm_eps)


@torch.inference_mode()
def forward_logits(params: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
                   plan: ExecPlan = ExecPlan()) -> torch.Tensor:
    """Full (B, S, V_pad) float32 logits (no chunking over the sequence)."""
    x, _ = embed_inputs(params, cfg, batch)
    return layers.unembed(params.unembed_w(), trunk(params, cfg, x, plan=plan)).to(torch.float32)


# ===================================================================== loss


def _ce_chunk(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
    """(Σ masked nll, Σ mask) of one chunk: logits in h's dtype, then float32."""
    logits = (h @ w).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def chunked_ce_loss(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, *,
                    chunk: int = 512) -> torch.Tensor:
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
        args = (h[:, j : j + chunk], w, labels[:, j : j + chunk], mask[:, j : j + chunk])
        if torch.is_grad_enabled():
            from torch.utils import checkpoint as ckpt

            nll, m = ckpt.checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            nll, m = _ce_chunk(*args)
        tot, cnt = tot + nll, cnt + m
    return tot / torch.clamp_min(cnt, 1.0)


def lm_loss(params: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
            plan: ExecPlan = ExecPlan()) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token CE (position t predicts token t + 1) + the MoE aux loss,
    and {"ce", "moe_aux"}: the single entry point of training."""
    x, mask = embed_inputs(params, cfg, batch)
    h = trunk(params, cfg, x, plan=plan)
    labels = batch["labels"].to(h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    ce = chunked_ce_loss(h[:, :-1], params.unembed_w(), labels[:, 1:], mask[:, 1:].to(h.device),
                         chunk=plan.loss_chunk)
    return ce + cfg.router_aux_coef * aux, {"ce": ce, "moe_aux": aux}


# ===================================================================== KV cache


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *, dtype: Optional[torch.dtype] = None,
               device=None) -> Dict[str, torch.Tensor]:
    """Decode cache for ``seq_len`` positions: {"k", "v"}, each (L, batch, seq_len,
    KV, hd) zeros in the config's dtype on ``device`` (default CUDA)."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, seq_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    dtype = dtype or torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev), "v": torch.zeros(shape, dtype=dtype, device=dev)}


# ===================================================================== decode


@torch.inference_mode()
def decode_step(params: LM, cfg: ArchConfig, tokens: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int, *,
                x_embed: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode at position ``pos`` (an int). tokens: (B,) ids, or
    ``x_embed`` (B, d) pre-embedded inputs in their place. Writes each layer's
    k, v into ``cache`` in place. Returns (logits (B, V_pad) float32, cache)."""
    x = params.embed(tokens[:, None]) if x_embed is None else x_embed[:, None, :]
    rot = int(cfg.resolved_head_dim * cfg.rope_fraction) & ~1
    tables = attention.decode_tables(int(pos), cache["k"].shape[2], rot, cfg.rope_theta, x.device)
    for l, layer in enumerate(params.layers):
        x = layer.decode(x, cache["k"][l], cache["v"][l], tables, cfg)
    h = params.final_norm(x, cfg.norm_eps)
    return layers.unembed(params.unembed_w(), h)[:, 0].to(torch.float32), cache


# ===================================================================== prefill


def _pad_seq(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Write (B, S, ...) ``src`` into the (B, cache_len, ...) cache ``dst`` as the
    reference's ``_pad_seq`` places it: at slots 0..S-1, or its last cache_len
    positions when S > cache_len."""
    S, cache_len = src.shape[1], dst.shape[1]
    if S > cache_len:
        dst.copy_(src[:, S - cache_len :])
    else:
        dst[:, :S] = src


@torch.inference_mode()
def batched_prefill(params: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *, cache_len: Optional[int] = None,
                    plan: ExecPlan = ExecPlan()) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Flash prefill: one batched pass over the prompt. Returns (last-token logits
    (B, V_pad) float32, a decode cache of ``cache_len`` positions (default S)
    positioned at pos = S)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x, _ = embed_inputs(params, cfg, batch)
    cache = init_cache(cfg, B, cache_len or S, device=x.device)
    for l, (layer, window) in enumerate(zip(params.layers, layer_windows(cfg).tolist())):
        x, (k, v) = layer(x, cfg, window, plan, return_kv=True)
        _pad_seq(cache["k"][l], k)
        _pad_seq(cache["v"][l], v)
    h = params.final_norm(x[:, -1:], cfg.norm_eps)
    return layers.unembed(params.unembed_w(), h)[:, 0].to(torch.float32), cache


@torch.inference_mode()
def prefill(params: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            cache: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fill the cache from a prompt by stepping ``decode_step`` over its positions
    (one code path for the cache's semantics). Returns (the last position's
    logits (B, V_pad) float32, cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x_all, _ = embed_inputs(params, cfg, batch)
    logits = torch.zeros((B, cfg.padded_vocab), dtype=torch.float32, device=x_all.device)
    for i in range(S):
        logits, cache = decode_step(params, cfg, tokens[:, i], cache, i, x_embed=x_all[:, i])
    return logits, cache
