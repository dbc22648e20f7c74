"""sasrec — unidirectional self-attentive recommender [arXiv:1808.09781].

embed_dim=50 n_blocks=2 n_heads=1 seq_len=50, next-item objective.
"""

from repro_torch.configs.registry import RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

FAMILY = "recsys"
SHAPES = RECSYS_SHAPES


def full_config() -> RecsysConfig:
    return RecsysConfig(name="sasrec", model_type="sasrec", embed_dim=50,
                        n_blocks=2, n_heads=1, seq_len=50,
                        item_vocab=1_000_000, n_negatives=2048)


def smoke_config() -> RecsysConfig:
    return RecsysConfig(name="sasrec-smoke", model_type="sasrec",
                        embed_dim=24, n_blocks=2, n_heads=1, seq_len=12,
                        item_vocab=499, n_negatives=32)
