"""Grok-1 314B MoE [hf:xai-org/grok-1; unverified]. 8 experts, top-2."""
from repro_torch.configs.base import ArchConfig, register


@register
def grok_1_314b() -> ArchConfig:
    return ArchConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=32768,
        vocab_size=131072,
        attn_kind="full",
        moe=True,
        num_experts=8,
        top_k=2,
        supports_long_context=False,
        long_context_note="pure full attention: 500k KV cache infeasible (64L × 8kv × 128hd)",
    )
