"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409; unverified].

ViT frontend is a STUB per the assignment: input_specs() feeds precomputed patch
embeddings (B, 256, 1024) which the backbone projects into d_model and prepends to the
token stream. Backbone = Mistral-NeMo-like dense decoder.
"""
from repro_torch.configs.base import ArchConfig, register


@register
def pixtral_12b() -> ArchConfig:
    return ArchConfig(
        name="pixtral-12b",
        family="vlm",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=160,
        d_ff=14336,
        vocab_size=131072,
        attn_kind="full",
        rope_theta=1e6,
        vlm=True,
        num_image_tokens=256,
        vit_dim=1024,
        supports_long_context=False,
        long_context_note="pure full attention: 500k KV cache infeasible and beyond published context",
    )
