"""Mixtral 8x7B [arXiv:2401.04088]. 8 experts top-2, sliding-window attention."""
from repro_torch.configs.base import ArchConfig, register


@register
def mixtral_8x7b() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        attn_kind="swa",
        window=4096,
        moe=True,
        num_experts=8,
        top_k=2,
        supports_long_context=True,
        long_context_note="SWA-4096 bounds the live KV window; rolling cache holds window tokens",
    )
