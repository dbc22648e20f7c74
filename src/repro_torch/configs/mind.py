"""mind — multi-interest network with dynamic (capsule) routing [arXiv:1904.08030].

embed_dim=64 n_interests=4 capsule_iters=3.
"""

from repro_torch.configs.registry import RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

FAMILY = "recsys"
SHAPES = RECSYS_SHAPES


def full_config() -> RecsysConfig:
    return RecsysConfig(name="mind", model_type="mind", embed_dim=64,
                        n_interests=4, capsule_iters=3, seq_len=50,
                        item_vocab=1_000_000, n_negatives=2048)


def smoke_config() -> RecsysConfig:
    return RecsysConfig(name="mind-smoke", model_type="mind", embed_dim=16,
                        n_interests=3, capsule_iters=2, seq_len=10,
                        item_vocab=211, n_negatives=16)
