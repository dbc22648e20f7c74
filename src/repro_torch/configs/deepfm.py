"""deepfm — FM + deep MLP CTR model [arXiv:1703.04247].

n_sparse=39 embed_dim=10 mlp=400-400-400; Criteo-scale field vocabularies
(26 categorical + 13 bucketized numeric = 39 sparse fields, ~33.8M rows).
"""

from repro_torch.configs.registry import RECSYS_SHAPES
from repro_torch.models.recsys import (CRITEO_CAT_VOCABS, CRITEO_NUM_BUCKETS,
                                 RecsysConfig)

FAMILY = "recsys"
SHAPES = RECSYS_SHAPES


def full_config() -> RecsysConfig:
    return RecsysConfig(name="deepfm", model_type="deepfm", embed_dim=10,
                        field_vocab_sizes=CRITEO_NUM_BUCKETS + CRITEO_CAT_VOCABS,
                        mlp_dims=(400, 400, 400), max_hot=1)


def smoke_config() -> RecsysConfig:
    return RecsysConfig(name="deepfm-smoke", model_type="deepfm", embed_dim=8,
                        field_vocab_sizes=(13, 7, 31, 17, 5, 23),
                        mlp_dims=(32, 32), max_hot=2)
