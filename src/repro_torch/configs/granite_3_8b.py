"""Granite-3 8B [hf:ibm-granite/granite-3.0; hf]. Plain GQA dense decoder."""
from repro_torch.configs.base import ArchConfig, register


@register
def granite_3_8b() -> ArchConfig:
    return ArchConfig(
        name="granite-3-8b",
        family="decoder",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12800,
        vocab_size=49155,
        attn_kind="full",
        supports_long_context=False,
        long_context_note="pure full attention: 500k KV cache infeasible",
    )
