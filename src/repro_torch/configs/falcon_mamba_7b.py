"""Falcon-Mamba 7B [arXiv:2410.05355]. Attention-free mamba1 stack."""
from repro_torch.configs.base import ArchConfig, register


@register
def falcon_mamba_7b() -> ArchConfig:
    return ArchConfig(
        name="falcon-mamba-7b",
        family="ssm",
        num_layers=64,
        d_model=4096,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=65024,
        ssm_state=16,
        d_conv=4,
        expand=2,
        supports_long_context=True,
        long_context_note="SSM: O(1) recurrent state, long_500k is the native regime",
    )
