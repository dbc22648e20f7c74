"""Dense-retriever bi-encoder: the port's Asyncval Encoder protocol.

:class:`EncoderSpec` mirrors ``repro.models.biencoder.EncoderSpec``: a pair
of functions over a parameter tree.  The port's spec also names the device
its parameters and inputs live on, and the checkpoint template
(``param_shapes``) its parameters are restored with.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.models import transformer as tfm


@dataclasses.dataclass
class EncoderSpec:
    """encode_query / encode_passage: (params, tokens (B, L) int32,
    mask (B, L) bool) -> (B, dim) f32 embeddings, all on ``device``."""

    name: str
    dim: int
    encode_query: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]
    encode_passage: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]
    init: Callable[[int], Any]            # seed -> numpy parameter tree
    param_shapes: Dict[str, Any]          # checkpoint template of the params
    device: torch.device = torch.device("cuda")
    q_max_len: int = 32
    p_max_len: int = 128


def biencoder_spec(cfg: tfm.TransformerConfig, *, pooling: str = "cls",
                   q_max_len: int = 32, p_max_len: int = 128,
                   device="cuda") -> EncoderSpec:
    """Shared-weight bi-encoder over a transformer trunk (Tevatron default)."""

    def enc(params, tokens, mask):
        return tfm.encode(params, cfg, tokens, mask, pooling)

    return EncoderSpec(name=cfg.name, dim=cfg.d_model, encode_query=enc,
                       encode_passage=enc,
                       init=lambda seed: tfm.init_numpy(cfg, seed),
                       param_shapes=tfm.param_shapes(cfg),
                       device=torch.device(device), q_max_len=q_max_len,
                       p_max_len=p_max_len)
