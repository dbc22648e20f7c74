"""Architecture registry: ``--arch <id>`` -> config + family metadata.

Holds only the architectures the port runs so far: the paper's
dr-bert-base bi-encoder and the dense LMs (qwen2-0.5b, qwen2-72b,
deepseek-67b).  The JAX package's MoE/MLA LMs, recsys and GNN
architectures wait for the slices that port those families.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict

_ARCH_MODULES = {
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "dr-bert-base": "repro_torch.configs.dr_bert_base",
}

ARCH_IDS = list(_ARCH_MODULES)


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

# The paper's own validation workload shapes (encode corpus / retrieve):
BIENCODER_SHAPES = {
    "train_contrastive": {"kind": "train", "global_batch": 256, "q_len": 32,
                          "p_len": 128, "n_passages": 2},
    "encode_corpus": {"kind": "encode", "batch": 4096, "p_len": 128},
    "retrieve": {"kind": "retrieve", "n_queries": 6980, "corpus": 8_841_823,
                 "dim": 768, "k": 1000},
}
