"""dr-bert-base — the paper's own architecture: BERT-base bi-encoder DR.

12L d_model=768 12H d_ff=3072 vocab=30522, post-LN, GELU, learned positions,
CLS pooling (``repro/configs/dr_bert_base.py``).
"""

from repro_torch.configs.registry import BIENCODER_SHAPES
from repro_torch.models.transformer import TransformerConfig

FAMILY = "biencoder"
SHAPES = BIENCODER_SHAPES


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="dr-bert-base", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        head_dim=64, d_ff=3072, vocab_size=30522, qkv_bias=True,
        use_rope=False, max_position_embeddings=512, norm_style="post",
        act="gelu", causal=False, q_chunk=128)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="dr-bert-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=211, qkv_bias=True,
        use_rope=False, max_position_embeddings=64, norm_style="post",
        act="gelu", causal=False, q_chunk=16)
