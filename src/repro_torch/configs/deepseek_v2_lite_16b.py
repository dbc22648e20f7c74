"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434].

27L d_model=2048 16H, MLA kv_lora=512 (qk_nope=128, qk_rope=64, v=128),
MoE: 64 routed experts top-6 + 2 shared, expert d_ff=1408, first layer dense
(d_ff=10944), vocab=102400.

Lite has 64 routed experts; the 160 routed experts belong to the full V2.
"""

from repro_torch.configs.registry import LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
SHAPES = LM_SHAPES


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16,
        n_kv_heads=16, head_dim=128, d_ff=10944, vocab_size=102400,
        rope_theta=10000.0, act="swiglu",
        mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128,
        moe_num_experts=64, moe_top_k=6, moe_d_ff=1408, moe_num_shared=2,
        first_k_dense=1, moe_mode="replace", q_chunk=512)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-v2-lite-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=211, act="swiglu",
        mla=True, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        moe_num_experts=8, moe_top_k=2, moe_d_ff=48, moe_num_shared=2,
        first_k_dense=1, moe_mode="replace", q_chunk=16)
