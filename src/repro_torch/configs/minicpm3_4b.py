"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]. MLA (multi-head latent attention)."""
from repro_torch.configs.base import ArchConfig, register


@register
def minicpm3_4b() -> ArchConfig:
    return ArchConfig(
        name="minicpm3-4b",
        family="decoder",
        num_layers=62,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,   # MLA: per-head latent KV, kv==q heads
        head_dim=64,
        d_ff=6400,
        vocab_size=73448,
        attn_kind="full",
        mla=True,
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_dim=64,
        qk_rope_dim=32,
        v_head_dim=64,
        supports_long_context=False,
        long_context_note="full attention; MLA shrinks the cache ~9x but 500k still exceeds the published 32k context; skipped",
    )
