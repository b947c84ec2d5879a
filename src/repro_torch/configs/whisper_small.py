"""Whisper-small [arXiv:2212.04356]. Enc-dec; conv frontend STUBBED — input_specs()
provides precomputed (B, 1500, d_model) frame embeddings."""
from repro_torch.configs.base import ArchConfig, register


@register
def whisper_small() -> ArchConfig:
    return ArchConfig(
        name="whisper-small",
        family="encdec",
        num_layers=12,        # decoder layers
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        attn_kind="full",
        encdec=True,
        enc_layers=12,
        enc_seq=1500,
        supports_long_context=False,
        long_context_note="enc-dec full attention; 500k decode far beyond the 448-token decoder context",
    )
