"""Gemma-3 12B [hf:google/gemma-3; unverified]. 5:1 local:global attention, 128k."""
from repro_torch.configs.base import ArchConfig, register


@register
def gemma3_12b() -> ArchConfig:
    return ArchConfig(
        name="gemma3-12b",
        family="decoder",
        num_layers=48,
        d_model=3840,
        num_heads=16,
        num_kv_heads=8,
        head_dim=240,
        d_ff=15360,
        vocab_size=262144,
        attn_kind="local_global",
        window=1024,
        local_global_ratio=5,
        rope_theta=1e6,
        supports_long_context=True,
        long_context_note=(
            "5/6 of layers are SWA-1024 (rolling cache); the 1/6 global layers keep a "
            "sequence-sharded 500k KV cache over the data axis"
        ),
    )
