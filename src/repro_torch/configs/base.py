"""Architecture config system: one frozen dataclass, a registry, and shape specs.

The port's own copy of ``repro.configs.base``. Every ported architecture
registers an ``ArchConfig`` (full published size) and can produce a
``reduced()`` copy for CPU tests. The dataclass keeps every field of the
reference's. Input shapes are global.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

_REGISTRY: Dict[str, Callable[[], "ArchConfig"]] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str                     # decoder | moe | ssm | hybrid | encdec | vlm
    # trunk
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0               # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0
    # attention pattern
    attn_kind: str = "full"         # full | swa | local_global
    window: int = 0                 # SWA window (swa / local layers)
    local_global_ratio: int = 0     # gemma3: 5 local per 1 global
    rope_theta: float = 1e4
    rope_fraction: float = 1.0      # chatglm 2d-rope: rotate only this fraction of dims
    # MLA (minicpm3)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # SSM (mamba1)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)
    # hybrid (hymba): parallel attn + ssm heads in every layer
    hybrid: bool = False
    # encoder-decoder (whisper)
    encdec: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500             # whisper frame count after the conv stub
    # VLM (pixtral)
    vlm: bool = False
    num_image_tokens: int = 256
    vit_dim: int = 1024
    # numerics / training
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    # shape applicability
    supports_long_context: bool = False   # may run long_500k
    long_context_note: str = ""

    # ------------------------------------------------------------------ derived
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (Megatron-style): embedding and
        unembedding shard over the 16-way tensor axis and want 128-lane alignment.
        The padded ids are ordinary trainable classes that no label ever selects;
        serving masks them out at sampling time."""
        m = 256
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Approximate parameter count (embedding + layers), for roofline MODEL_FLOPS."""
        d, V = self.d_model, self.vocab_size
        total = V * d * (1 if self.tie_embeddings else 2)
        hd = self.resolved_head_dim

        def attn_params() -> int:
            if self.mla:
                q_up_in = self.q_lora_rank or d
                p = d * (self.q_lora_rank or 0)
                p += q_up_in * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                p += d * (self.kv_lora_rank + self.qk_rope_dim)
                p += self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                p += self.num_heads * self.v_head_dim * d
                return p
            return d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d

        def ffn_params() -> int:
            if self.moe:
                return self.num_experts * 3 * d * self.d_ff + d * self.num_experts
            return 3 * d * self.d_ff

        def ssm_params() -> int:
            di, r, st = self.d_inner, self.resolved_dt_rank, self.ssm_state
            return d * 2 * di + self.d_conv * di + di * (r + 2 * st) + r * di + di * st + di + di * d

        per_layer = 0
        if self.family == "ssm":
            per_layer = ssm_params()
        elif self.family == "hybrid":
            per_layer = attn_params() + ssm_params() + ffn_params()
        else:
            per_layer = attn_params() + ffn_params()
        total += self.num_layers * per_layer
        if self.encdec:
            enc_per = d * self.num_heads * hd * 2 + 2 * d * self.num_kv_heads * hd * 1 + 3 * d * self.d_ff
            total += self.enc_layers * enc_per
            total += self.num_layers * (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d)  # cross-attn
        if self.vlm:
            total += self.vit_dim * d
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of num_experts)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.num_layers * self.num_experts * 3 * d * self.d_ff
        return dense + self.num_layers * self.top_k * 3 * d * self.d_ff

    # ------------------------------------------------------------------ reduction
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (one fwd/train step)."""
        heads = min(self.num_heads, 4) or 4
        kv = max(1, min(self.num_kv_heads, 2)) if self.num_kv_heads else heads
        # local_global archs need a full period of layers (e.g. gemma3's 5 local + 1
        # global) for the grouped decode-cache path to be exercised.
        min_layers = (self.local_global_ratio + 1) if self.local_global_ratio > 0 else 2
        changes = dict(
            num_layers=min(self.num_layers, min_layers),
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=0 if self.family == "ssm" else 128,
            vocab_size=256,
            window=min(self.window, 8) if self.window else 0,
            enc_layers=min(self.enc_layers, 2),
            enc_seq=16 if self.encdec else self.enc_seq,
            num_image_tokens=4 if self.vlm else self.num_image_tokens,
            vit_dim=32 if self.vlm else self.vit_dim,
            num_experts=min(self.num_experts, 4) if self.moe else 0,
            q_lora_rank=16 if self.mla else 0,
            kv_lora_rank=16 if self.mla else 0,
            qk_nope_dim=8 if self.mla else 0,
            qk_rope_dim=8 if self.mla else 0,
            v_head_dim=16 if self.mla else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            dt_rank=8 if self.ssm_state else 0,
            dtype="float32",
        )
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------- registry


def register(fn: Callable[[], ArchConfig]) -> Callable[[], ArchConfig]:
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        # import all config modules lazily so the registry is populated
        from repro_torch import configs as _  # noqa

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    from repro_torch import configs as _  # noqa

    return sorted(_REGISTRY)


# ---------------------------------------------------------------------- shapes


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; reason string when skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, cfg.long_context_note or "pure full-attention stack: 500k dense KV cache is quadratic-memory infeasible"
    return True, ""
