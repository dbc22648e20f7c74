"""qwen2-72b — dense LM with GQA + QKV bias [arXiv:2407.10671].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
"""

from repro_torch.configs.registry import LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
SHAPES = LM_SHAPES


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-72b", n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=29568, vocab_size=152064, qkv_bias=True,
        rope_theta=1_000_000.0, act="swiglu", tie_embeddings=False, q_chunk=512)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-72b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=160, vocab_size=211, qkv_bias=True, act="swiglu",
        q_chunk=16)
