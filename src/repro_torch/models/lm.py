"""The decoder LM of the port: parameters, forward, KV cache, decode and prefill.

Port of ``repro.models.lm`` for the decoder families: dense (SwiGLU; RoPE at
any ``rope_fraction``: granite-3-8b, chatglm3-6b), MoE (``models.moe``:
mixtral-8x7b, grok-1-314b), sliding-window attention (mixtral's ``window``),
gemma3's local:global pattern (``local_global_ratio`` windowed layers, then one
global), MLA (``attention.mla_*``: minicpm3-4b) and the hybrid layer
(hymba-1.5b: GQA with a window beside a Mamba branch of ``models.ssm``, both
reading the same normed input, fused as rmsnorm(a)·β_a + rmsnorm(s)·β_s). A
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
float32} beside its ring. Every attention cache is the reference's ring, slot p
mod S_c for position p. Configs of the attention-free SSM family
(falcon-mamba-7b), the encoder-decoder and the VLM families raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers, moe as moe_lib, ssm as ssm_lib
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

# Features of the reference's other families, each with the ROADMAP Queue 1 slice
# of item 9 that ports it.
_UNPORTED = (
    (lambda c: c.family == "ssm", "the attention-free SSM family", "9d"),
    (lambda c: c.encdec or c.family == "encdec", "the encoder-decoder family", "9e"),
    (lambda c: c.vlm or c.family == "vlm", "the VLM family", "9e"),
)


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config outside the ported decoder families."""
    missing = [(what, item) for test, what, item in _UNPORTED if test(cfg)]
    if missing:
        parts = ", ".join(f"{what} (ROADMAP Queue 1 item {item})" for what, item in missing)
        raise NotImplementedError(f"{cfg.name} ({cfg.family}): {parts} is not ported to repro_torch yet; "
                                  "only the decoder families with attention (dense, MoE, MLA and hybrid) are")


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """Execution knobs, orthogonal to the architecture config."""

    attn_chunk: int = 1024      # flash key-chunk: attention's memory is O(S·attn_chunk)
    loss_chunk: int = 512       # CE vocab-matmul sequence chunk
    ssm_chunk: int = 128        # Mamba scan chunk: its float32 tiles are (B, ssm_chunk, C, N)
    remat: str = "full"         # none | full | dots (applies where autograd records)


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
    """One pre-norm decoder layer, h = norm1(x): x + attn(h) (GQA or MLA), then +
    ffn(norm2(·)), the FFN a SwiGLU (``ffn``) or a mixture of experts
    (``moe``). A hybrid layer's mixer is ``fuse``(attn(h), mamba(h)); other
    layers have no ``mamba`` and ``fuse`` (None)."""

    def __init__(self, norm1: layers.RMSNorm, attn: nn.Module, norm2: layers.RMSNorm, ffn: nn.Module, *,
                 mamba: Optional[ssm_lib.Mamba] = None, fuse: Optional[Fuse] = None):
        super().__init__()
        self.norm1, self.attn, self.mamba, self.fuse, self.norm2 = norm1, attn, mamba, fuse, norm2
        if isinstance(ffn, moe_lib.MoE):
            self.moe = ffn
        else:
            self.ffn = ffn

    def _ffn(self, h: torch.Tensor, cfg: ArchConfig):
        """(G, T, d) -> (out, MoE aux loss or None); an MoE groups by the first axis."""
        if cfg.moe:
            return self.moe(h, num_experts=cfg.num_experts, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
        return self.ffn(h), None

    def _attn_args(self, cfg: ArchConfig) -> dict:
        if cfg.mla:
            return dict(heads=cfg.num_heads, kv_lora=cfg.kv_lora_rank, nope=cfg.qk_nope_dim, rope_d=cfg.qk_rope_dim,
                        v_dim=cfg.v_head_dim)
        return dict(heads=cfg.num_heads, kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
                    rope_fraction=cfg.rope_fraction)

    def _ssm_args(self, cfg: ArchConfig) -> dict:
        return dict(state=cfg.ssm_state, dt_rank=cfg.resolved_dt_rank)

    def forward(self, x: torch.Tensor, cfg: ArchConfig, window: int, plan: ExecPlan, *, return_kv: bool = False):
        """(B, S, d) -> (x (B, S, d), MoE aux or None, each sequence an MoE group);
        with ``return_kv`` also this layer's cache piece by the cache's names:
        the post-RoPE "k", "v"; MLA's "ckv", "krope"; a Mamba branch's "conv"
        (the last K − 1 pre-conv inputs) and "ssm" (h_T)."""
        h = self.norm1(x, cfg.norm_eps)
        piece = {}
        fwd, names = (attention.mla_forward, ("ckv", "krope")) if cfg.mla else (
            functools.partial(attention.gqa_forward, window=window), ("k", "v"))
        a = fwd(self.attn, h, rope_theta=cfg.rope_theta, chunk=plan.attn_chunk, return_kv=return_kv,
                **self._attn_args(cfg))
        if return_kv:
            a, kv = a
            piece.update(zip(names, kv))
        if self.mamba is not None:
            s = ssm_lib.mamba_forward(self.mamba, h, chunk=plan.ssm_chunk, return_state=return_kv,
                                      **self._ssm_args(cfg))
            if return_kv:
                s, (piece["conv"], piece["ssm"]) = s
            a = self.fuse(a, s, cfg.norm_eps)
        x = x + a
        f, aux = self._ffn(self.norm2(x, cfg.norm_eps), cfg)
        return (x + f, aux, piece) if return_kv else (x + f, aux)

    def decode(self, x: torch.Tensor, lc: Dict[str, torch.Tensor], tables, cfg: ArchConfig) -> torch.Tensor:
        """One token (B, 1, d) against this layer's cache views ``lc``
        (:func:`layer_caches`), written in place; ``tables`` is
        ``attention.decode_tables`` of the position for the attention's cache."""
        h = self.norm1(x, cfg.norm_eps)
        if cfg.mla:
            a = attention.mla_decode(self.attn, h, lc["ckv"], lc["krope"], tables, **self._attn_args(cfg))
        else:
            a = attention.gqa_decode(self.attn, h, lc["k"], lc["v"], tables, **self._attn_args(cfg))
        if self.mamba is not None:
            s, conv, state = ssm_lib.mamba_decode(self.mamba, h, lc["conv"], lc["ssm"], **self._ssm_args(cfg))
            lc["conv"].copy_(conv)
            lc["ssm"].copy_(state)
            a = self.fuse(a, s, cfg.norm_eps)
        x = x + a
        B, d = x.shape[0], x.shape[2]
        f, _ = self._ffn(self.norm2(x, cfg.norm_eps).reshape(1, B, d), cfg)  # the batch is the MoE group
        return x + f.reshape(B, 1, d)


class LM(nn.Module):
    """A decoder LM: ``embed``, ``layers`` (an ``nn.ModuleList``), ``final_norm``
    and ``unembed`` (None when the embedding is tied). Its state dict's names
    follow the reference's tree: ``embed.table``, ``layers.<l>.attn.wq`` (MLA:
    ``.attn.w_dkv`` and so on), ``layers.<l>.ffn.w_gate`` (or
    ``layers.<l>.moe.router``, ``.moe.w_gate``), ``layers.<l>.mamba.in_proj``,
    ``layers.<l>.fuse.norm_a.scale``, ``final_norm.scale``, ``unembed.w``."""

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
    # The reference's per-layer split: attn ks[0], a hybrid's mamba ks[1], ffn or moe ks[3].
    ks = prng.split(key, 8)
    d = cfg.d_model
    if cfg.mla:
        attn = attention.init_mla(ks[0], d, cfg.num_heads, q_lora=cfg.q_lora_rank, kv_lora=cfg.kv_lora_rank,
                                  nope=cfg.qk_nope_dim, rope_d=cfg.qk_rope_dim, v_dim=cfg.v_head_dim, dtype=dtype,
                                  device=device)
    else:
        attn = attention.init_gqa(ks[0], d, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, dtype, device)
    mamba = fuse = None
    if cfg.hybrid:
        mamba = ssm_lib.init_mamba(ks[1], d, d_inner=cfg.d_inner, state=cfg.ssm_state, d_conv=cfg.d_conv,
                                   dt_rank=cfg.resolved_dt_rank, dtype=dtype, device=device)
        half = lambda: torch.full((d,), 0.5, dtype=dtype, device=device)
        fuse = Fuse(layers.init_rmsnorm(d, dtype, device), layers.init_rmsnorm(d, dtype, device), half(), half())
    if cfg.moe:
        ffn = moe_lib.init_moe(ks[3], d, cfg.d_ff, cfg.num_experts, dtype, device)
    else:
        ffn = layers.init_swiglu(ks[3], d, cfg.d_ff, dtype, device)
    return DecoderLayer(layers.init_rmsnorm(d, dtype, device), attn, layers.init_rmsnorm(d, dtype, device), ffn,
                        mamba=mamba, fuse=fuse)


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
    shapes = {"embed.table": (V, d), "norm1.scale": (d,), "final_norm.scale": (d,)}
    if not cfg.tie_embeddings:
        shapes["unembed.w"] = (d, V)
    if cfg.hybrid:
        C, N, r, K = cfg.d_inner, cfg.ssm_state, cfg.resolved_dt_rank, cfg.d_conv
        shapes.update({"mamba.in_proj": (d, 2 * C), "mamba.conv_w": (K, C), "mamba.conv_b": (C,),
                       "mamba.x_proj": (C, r + 2 * N), "mamba.dt_proj_w": (r, C), "mamba.dt_proj_b": (C,),
                       "mamba.A_log": (C, N), "mamba.D": (C,), "mamba.out_proj": (C, d)})
    H = cfg.num_heads
    if cfg.mla:
        nope, rope_d, v = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        shapes.update({"attn.w_dq": (d, cfg.q_lora_rank), "attn.w_uq": (cfg.q_lora_rank, H * (nope + rope_d)),
                       "attn.w_dkv": (d, cfg.kv_lora_rank + rope_d), "attn.w_ukv": (cfg.kv_lora_rank, H * (nope + v)),
                       "attn.wo": (H * v, d)})
    else:
        qd, kvd = H * cfg.resolved_head_dim, cfg.num_kv_heads * cfg.resolved_head_dim
        shapes.update({"attn.wq": (d, qd), "attn.wk": (d, kvd), "attn.wv": (d, kvd), "attn.wo": (qd, d)})
    if cfg.hybrid:
        shapes.update({"fuse.norm_a.scale": (d,), "fuse.norm_s.scale": (d,), "fuse.beta_a": (d,), "fuse.beta_s": (d,)})
    shapes["norm2.scale"] = (d,)
    if cfg.moe:
        E = cfg.num_experts
        shapes.update({"moe.router": (d, E), "moe.w_gate": (E, d, f), "moe.w_up": (E, d, f),
                       "moe.w_down": (E, f, d)})
    else:
        shapes.update({"ffn.w_gate": (d, f), "ffn.w_up": (d, f), "ffn.w_down": (f, d)})
    return shapes


def leaf_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """A leaf's dtype in a model of ``dtype``: the config's, but a Mamba block's
    ``A_log``, which is float32 in every model."""
    return torch.float32 if name.endswith("A_log") else dtype


def _assemble(cfg: ArchConfig, leaf) -> LM:
    """An LM from ``leaf(name, l)``: the tensor of leaf ``name`` (of layer l, or
    None outside the layers)."""
    def layer(l):
        g = lambda n: leaf(n, l)
        if cfg.mla:
            attn = attention.MLA(**{n: g(f"attn.{n}") for n in attention.MLA.LEAVES})
        else:
            attn = attention.GQA(g("attn.wq"), g("attn.wk"), g("attn.wv"), g("attn.wo"))
        mamba = fuse = None
        if cfg.hybrid:
            mamba = ssm_lib.Mamba(**{n: g(f"mamba.{n}") for n in ssm_lib.Mamba.LEAVES})
            fuse = Fuse(layers.RMSNorm(g("fuse.norm_a.scale")), layers.RMSNorm(g("fuse.norm_s.scale")),
                        g("fuse.beta_a"), g("fuse.beta_s"))
        if cfg.moe:
            ffn = moe_lib.MoE(g("moe.router"), g("moe.w_gate"), g("moe.w_up"), g("moe.w_down"))
        else:
            ffn = layers.SwiGLU(g("ffn.w_gate"), g("ffn.w_up"), g("ffn.w_down"))
        return DecoderLayer(layers.RMSNorm(g("norm1.scale")), attn, layers.RMSNorm(g("norm2.scale")), ffn,
                            mamba=mamba, fuse=fuse)

    return LM(cfg, layers.Embedding(leaf("embed.table", None)), [layer(l) for l in range(cfg.num_layers)],
              layers.RMSNorm(leaf("final_norm.scale", None)),
              None if cfg.tie_embeddings else layers.Unembed(leaf("unembed.w", None)))


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
    return _assemble(cfg, lambda name, l: named[name if l is None else f"layers.{l}.{name}"])


@torch.no_grad()
def params_from_reference(cfg: ArchConfig, tree, *, device=None) -> LM:
    """The model holding the reference's parameter tree ``tree`` (numpy arrays or
    anything ``np.asarray`` takes; layer leaves stacked on a leading L axis, as
    ``repro.models.lm.init_params`` makes them), in the config's dtype (``A_log``
    float32) on ``device`` (default CUDA). bfloat16 leaves convert exactly."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)

    def leaf(name: str, l: Optional[int]):
        node = tree if l is None else tree["layers"]
        for part in name.split("."):
            node = node[part]
        t = torch.from_numpy(np.array(node if l is None else node[l], dtype=np.float32))
        return t.to(device=dev, dtype=leaf_dtype(name, dtype))

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


def trunk(params: LM, cfg: ArchConfig, x: torch.Tensor, *,
          plan: ExecPlan = ExecPlan()) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layers over x: (B, S, d), each under ``plan.remat``. Returns (the
    final-norm hidden states, the MoE aux loss summed over the layers in
    float32; 0 for a dense model)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, window in zip(params.layers, layer_windows(cfg).tolist()):
        x, a = _remat(lambda x, layer=layer, window=window: layer(x, cfg, window, plan), plan.remat, x)
        if a is not None:
            aux = aux + a
    return params.final_norm(x, cfg.norm_eps), aux


@torch.inference_mode()
def forward_logits(params: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
                   plan: ExecPlan = ExecPlan()) -> torch.Tensor:
    """Full (B, S, V_pad) float32 logits (no chunking over the sequence)."""
    x, _ = embed_inputs(params, cfg, batch)
    return layers.unembed(params.unembed_w(), trunk(params, cfg, x, plan=plan)[0]).to(torch.float32)


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
    h, aux = trunk(params, cfg, x, plan=plan)
    labels = batch["labels"].to(h.device)
    ce = chunked_ce_loss(h[:, :-1], params.unembed_w(), labels[:, 1:], mask[:, 1:].to(h.device),
                         chunk=plan.loss_chunk)
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
    "ssm" (L, batch, C, N), the latter float32 always."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(cfg)
    L = cfg.num_layers
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)

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
        cache.update(conv=zeros(L, batch, cfg.d_conv - 1, cfg.d_inner),
                     ssm=zeros(L, batch, cfg.d_inner, cfg.ssm_state, dt=torch.float32))
    return cache


def layer_caches(cfg: ArchConfig, cache: dict) -> List[Dict[str, torch.Tensor]]:
    """Each decoded layer's cache views by name ("k", "v"; "ckv", "krope";
    "conv", "ssm"), layer l's entry of each leaf. With the local:global split,
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


@torch.inference_mode()
def decode_step(params: LM, cfg: ArchConfig, tokens: torch.Tensor, cache: dict, pos: int, *,
                x_embed: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
    """One-token decode at position ``pos`` (an int). tokens: (B,) ids, or
    ``x_embed`` (B, d) pre-embedded inputs in their place. Writes each layer's
    k, v (MLA: c_kv, k_rope) into its ring of ``cache`` and its Mamba states
    over theirs, in place (``layer_caches``). Returns (logits (B, V_pad)
    float32, cache)."""
    x = params.embed(tokens[:, None]) if x_embed is None else x_embed[:, None, :]
    rot = cfg.qk_rope_dim if cfg.mla else int(cfg.resolved_head_dim * cfg.rope_fraction) & ~1
    seq_leaf = "ckv" if cfg.mla else "k"
    tables = {}  # by ring length: the local rings and the global caches of gemma3
    for layer, lc in zip(params.layers, layer_caches(cfg, cache)):
        s_cache = lc[seq_leaf].shape[1]
        if s_cache not in tables:
            tables[s_cache] = attention.decode_tables(int(pos), s_cache, rot, cfg.rope_theta, x.device)
        x = layer.decode(x, lc, tables[s_cache], cfg)
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


def _ring_place(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Write the last min(S_c, S) positions of (B, S, ...) ``src`` into the ring
    (B, S_c, ...) ``dst`` at slots p mod S_c (the reference's ``_ring_place``;
    the other slots stay zero)."""
    S, s_cache = src.shape[1], dst.shape[1]
    take = min(s_cache, S)
    slots = torch.arange(S - take, S, device=dst.device) % s_cache
    dst[:, slots] = src[:, S - take :]


@torch.inference_mode()
def batched_prefill(params: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *, cache_len: Optional[int] = None,
                    plan: ExecPlan = ExecPlan()) -> Tuple[torch.Tensor, dict]:
    """Flash prefill: one batched pass over the prompt. Returns (last-token logits
    (B, V_pad) float32, a decode cache of ``cache_len`` positions (default S)
    positioned at pos = S). A windowed layer's k, v go to its ring at slots
    p mod S_c (``_ring_place``), a full layer's (and MLA's latent) to slots
    0…S−1 (``_pad_seq``); a Mamba branch's conv tail and h_T are its states."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x, _ = embed_inputs(params, cfg, batch)
    cache = init_cache(cfg, B, cache_len or S, device=x.device)
    slots = layer_caches(cfg, cache)
    for l, (layer, window) in enumerate(zip(params.layers, layer_windows(cfg).tolist())):
        x, _, piece = layer(x, cfg, window, plan, return_kv=True)
        if l < len(slots):
            for name, t in piece.items():
                if name in ("conv", "ssm"):
                    slots[l][name].copy_(t)
                else:
                    (_ring_place if window > 0 else _pad_seq)(slots[l][name], t)
    h = params.final_norm(x[:, -1:], cfg.norm_eps)
    return layers.unembed(params.unembed_w(), h)[:, 0].to(torch.float32), cache


@torch.inference_mode()
def prefill(params: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor], cache: dict) -> Tuple[torch.Tensor, dict]:
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
