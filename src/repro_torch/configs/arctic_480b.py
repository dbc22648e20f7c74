"""arctic-480b — dense + residual-MoE hybrid [hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000; 128 experts top-2
applied as a *residual* branch in parallel with the dense FFN.
"""

from repro_torch.configs.registry import LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
SHAPES = LM_SHAPES


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="arctic-480b", n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
        head_dim=128, d_ff=4864, vocab_size=32000, qkv_bias=False,
        rope_theta=10000.0, act="swiglu",
        moe_num_experts=128, moe_top_k=2, moe_d_ff=4864, moe_mode="residual",
        moe_capacity_factor=1.25, q_chunk=512)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="arctic-480b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=96, vocab_size=211, act="swiglu",
        moe_num_experts=8, moe_top_k=2, moe_d_ff=96, moe_mode="residual",
        q_chunk=16)
