"""deepseek-67b — dense llama-arch LM [arXiv:2401.02954].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""

from repro_torch.configs.registry import LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
SHAPES = LM_SHAPES


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-67b", n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=22016, vocab_size=102400, qkv_bias=False,
        rope_theta=10000.0, act="swiglu", tie_embeddings=False, q_chunk=512)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-67b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=257, qkv_bias=False, act="swiglu",
        q_chunk=16)
