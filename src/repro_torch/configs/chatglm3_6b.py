"""ChatGLM3-6B [arXiv:2406.12793]. GQA kv=2, 2d-RoPE (rotary on half the dims)."""
from repro_torch.configs.base import ArchConfig, register


@register
def chatglm3_6b() -> ArchConfig:
    return ArchConfig(
        name="chatglm3-6b",
        family="decoder",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab_size=65024,
        attn_kind="full",
        rope_fraction=0.5,
        supports_long_context=False,
        long_context_note="pure full attention: 500k KV cache infeasible",
    )
