"""Architecture registry: ``--arch <id>`` -> config + family metadata.

Every architecture of the JAX package's registry
(``repro/configs/registry.py``), in its order: the LMs (dense, MoE, MLA),
GraphCast, the four recommenders and the paper's dr-bert-base bi-encoder.

Each arch module exposes:
  FAMILY        : "lm" | "gnn" | "recsys" | "biencoder"
  full_config() : the published configuration
  smoke_config(): reduced same-family config (CPU tests)
  SHAPES        : dict shape_name -> shape params (family-specific)
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict

_ARCH_MODULES = {
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "graphcast": "repro_torch.configs.graphcast",
    "bert4rec": "repro_torch.configs.bert4rec",
    "sasrec": "repro_torch.configs.sasrec",
    "mind": "repro_torch.configs.mind",
    "deepfm": "repro_torch.configs.deepfm",
    # the paper's own architecture (BERT-based dense-retriever bi-encoder)
    "dr-bert-base": "repro_torch.configs.dr_bert_base",
}

ARCH_IDS = list(_ARCH_MODULES)
ASSIGNED_ARCH_IDS = [a for a in ARCH_IDS if a != "dr-bert-base"]


@dataclasses.dataclass
class ArchSpec:
    arch_id: str
    family: str
    full_config: Callable[[], Any]
    smoke_config: Callable[[], Any]
    shapes: Dict[str, dict]
    module: Any


def get(arch_id: str) -> ArchSpec:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(_ARCH_MODULES[arch_id])
    return ArchSpec(arch_id=arch_id, family=mod.FAMILY,
                    full_config=mod.full_config,
                    smoke_config=mod.smoke_config, shapes=dict(mod.SHAPES),
                    module=mod)


# Shape tables shared within each family -----------------------------------

LM_SHAPES = {
    "train_4k": {"kind": "train", "seq_len": 4096, "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32768, "global_batch": 32},
    "decode_32k": {"kind": "decode", "seq_len": 32768, "global_batch": 128},
    "long_500k": {"kind": "decode", "seq_len": 524288, "global_batch": 1},
}

GNN_SHAPES = {
    "full_graph_sm": {"kind": "full_graph", "n_nodes": 2708, "n_edges": 10556,
                      "d_feat": 1433},
    "minibatch_lg": {"kind": "minibatch", "n_nodes": 232965,
                     "n_edges": 114615892, "batch_nodes": 1024,
                     "fanout": (15, 10)},
    "ogb_products": {"kind": "full_graph", "n_nodes": 2449029,
                     "n_edges": 61859140, "d_feat": 100},
    "molecule": {"kind": "batched_graphs", "n_nodes": 30, "n_edges": 64,
                 "batch": 128},
}

RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512},
    "serve_bulk": {"kind": "serve", "batch": 262144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}

# The paper's own validation workload shapes (encode corpus / retrieve):
BIENCODER_SHAPES = {
    "train_contrastive": {"kind": "train", "global_batch": 256, "q_len": 32,
                          "p_len": 128, "n_passages": 2},
    "encode_corpus": {"kind": "encode", "batch": 4096, "p_len": 128},
    "retrieve": {"kind": "retrieve", "n_queries": 6980, "corpus": 8_841_823,
                 "dim": 768, "k": 1000},
}
