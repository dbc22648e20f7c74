"""graphcast — encoder-processor-decoder mesh GNN [arXiv:2212.12794].

n_layers=16 d_hidden=512 mesh_refinement=6 aggregator=sum n_vars=227.
The shapes run the same block over generic benchmark graphs (see
``repro_torch.models.graphcast``).
"""

from repro_torch.configs.registry import GNN_SHAPES
from repro_torch.models.graphcast import GraphCastConfig

FAMILY = "gnn"
SHAPES = GNN_SHAPES


def full_config() -> GraphCastConfig:
    return GraphCastConfig(name="graphcast", n_layers=16, d_hidden=512,
                           n_vars=227, d_feat=227, mesh_refinement=6,
                           aggregator="sum")


def smoke_config() -> GraphCastConfig:
    return GraphCastConfig(name="graphcast-smoke", n_layers=2, d_hidden=32,
                           n_vars=7, d_feat=11, mesh_refinement=1,
                           aggregator="sum")
