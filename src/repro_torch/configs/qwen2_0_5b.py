"""qwen2-0.5b — dense LM with GQA + QKV bias [arXiv:2407.10671].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936, tied embeddings.
"""

from repro_torch.configs.registry import LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
SHAPES = LM_SHAPES


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-0.5b", n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        head_dim=64, d_ff=4864, vocab_size=151936, qkv_bias=True,
        rope_theta=1_000_000.0, act="swiglu", tie_embeddings=True, q_chunk=512)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-0.5b-smoke", n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
        head_dim=8, d_ff=96, vocab_size=211, qkv_bias=True, act="swiglu",
        tie_embeddings=True, q_chunk=16)
