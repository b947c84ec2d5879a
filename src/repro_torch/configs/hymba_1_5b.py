"""Hymba-1.5B [arXiv:2411.13676]. Parallel attention + mamba heads per layer."""
from repro_torch.configs.base import ArchConfig, register


@register
def hymba_1_5b() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        attn_kind="swa",     # hymba uses SWA + meta tokens on most layers
        window=1024,
        ssm_state=16,
        d_conv=4,
        expand=2,
        hybrid=True,
        supports_long_context=True,
        long_context_note="hybrid: SSM branch carries long-range state; attn branch is SWA (rolling cache)",
    )
