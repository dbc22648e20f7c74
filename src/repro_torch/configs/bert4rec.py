"""bert4rec — bidirectional sequential recommender [arXiv:1904.06690].

embed_dim=64 n_blocks=2 n_heads=2 seq_len=200, cloze (masked-item) objective.
"""

from repro_torch.configs.registry import RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

FAMILY = "recsys"
SHAPES = RECSYS_SHAPES


def full_config() -> RecsysConfig:
    return RecsysConfig(name="bert4rec", model_type="bert4rec", embed_dim=64,
                        n_blocks=2, n_heads=2, seq_len=200,
                        item_vocab=1_000_000, n_negatives=2048)


def smoke_config() -> RecsysConfig:
    return RecsysConfig(name="bert4rec-smoke", model_type="bert4rec",
                        embed_dim=32, n_blocks=2, n_heads=2, seq_len=16,
                        item_vocab=997, n_negatives=32)
