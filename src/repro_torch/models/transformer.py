"""The BERT-style encoder trunk of the JAX package's transformer, in PyTorch.

Only the trunk the dense retriever runs is ported
(``repro/models/transformer.py``: ``forward`` with a key mask, then
``encode``): post-LN layers with learned positions, QKV bias, GELU (tanh)
MLPs, bidirectional attention, and ``final_norm`` after the stack.  The
LM-only features (RoPE, RMSNorm, SwiGLU, MoE, MLA, KV caches, causal masks)
wait for the slice that ports the LM path; a config asking for one raises.

Parameters keep the reference's key paths and its stacked leading ``L``
axis (``embed``, ``pos_embed``, ``dense_layers/{attn,attn_norm,mlp,
mlp_norm}``, ``final_norm``, ``lm_head``), so the JAX package's parameter
trees and checkpoints load without renaming (:func:`params_from_numpy`).

Attention is computed as the reference's ``_chunked_attention``: query
chunks of ``q_chunk`` rows, compute-dtype operands multiplied into f32 sums,
padded keys masked with ``-1e30``, softmax in f32, and the probabilities
cast to the value dtype before the second product.  The products run as
f32 matmuls of compute-dtype values, which is exact for bf16 inputs and so
is the reference's "bf16 operands, f32 accumulation".
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models import nn


@dataclasses.dataclass
class TransformerConfig:
    name: str = "transformer"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 32
    d_ff: int = 512
    vocab_size: int = 1000
    qkv_bias: bool = False
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    causal: bool = False
    act: str = "gelu"
    use_rope: bool = False
    max_position_embeddings: int = 0
    norm_style: str = "post"
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    q_chunk: int = 512


def _check_encoder(cfg: TransformerConfig) -> None:
    if (cfg.causal or cfg.use_rope or cfg.norm_style != "post"
            or cfg.act != "gelu" or not cfg.max_position_embeddings):
        raise NotImplementedError(
            f"{cfg.name}: only the BERT-style encoder trunk (post-LN, GELU, "
            "learned positions, bidirectional) is ported so far")


def param_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    """The parameter tree's structure with each leaf's shape — the template
    :func:`repro_torch.ckpt.checkpoint.restore` reads a checkpoint with."""
    _check_encoder(cfg)
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    Hd, KVd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    norm = {"scale": (L, D), "bias": (L, D)}
    attn = {"wq": (L, D, Hd), "wk": (L, D, KVd), "wv": (L, D, KVd),
            "wo": (L, Hd, D)}
    if cfg.qkv_bias:
        attn.update(bq=(L, Hd), bk=(L, KVd), bv=(L, KVd))
    shapes = {
        "embed": {"table": (cfg.vocab_size, D)},
        "pos_embed": {"table": (cfg.max_position_embeddings, D)},
        "dense_layers": {
            "attn": attn, "attn_norm": dict(norm), "mlp_norm": dict(norm),
            "mlp": {"w1": {"w": (L, D, F), "b": (L, F)},
                    "w2": {"w": (L, F, D), "b": (L, D)}}},
        "final_norm": {"scale": (D,), "bias": (D,)},
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = {"w": (D, cfg.vocab_size)}
    return shapes


def init_numpy(cfg: TransformerConfig, seed: int) -> Dict[str, Any]:
    """Random parameters as nested dicts of numpy f32 arrays, drawn from
    ``numpy.random.default_rng(seed)``: norm scales 1, biases 0, embedding
    tables N(0, 0.02), weights N(0, 1/fan_in).  The scheme is the
    reference's; the numbers are not (JAX draws from its own generator)."""
    rng = np.random.default_rng(seed)

    def build(node, name):
        if isinstance(node, dict):
            return {key: build(node[key], key) for key in sorted(node)}
        if name == "scale":
            return np.ones(node, np.float32)
        if name in ("bias", "b", "bq", "bk", "bv"):
            return np.zeros(node, np.float32)
        std = 0.02 if name == "table" else 1.0 / np.sqrt(node[-2])
        return rng.standard_normal(node, dtype=np.float32) * np.float32(std)

    return build(param_shapes(cfg), "")


def params_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX package's parameter tree (nested dicts of numpy arrays, as
    ``repro.ckpt.restore`` or ``nn.materialize(tfm.init(...))`` gives it;
    tensors are taken too) -> the port's parameters on ``device``, with the
    same key paths and dtypes."""
    missing = [key for key in ("embed", "pos_embed", "dense_layers",
                               "final_norm") if key not in tree]
    if missing:
        raise ValueError(f"not a BERT encoder parameter tree: missing "
                         f"{missing}")
    return nn.to_torch_tree(tree, device)


def _chunked_attention(q, k, v, *, q_chunk: int,
                       kv_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B, S, KV, G, hd); k, v (B, T, KV, hd); kv_mask (B, T) bool.
    Returns (B, S, KV, G, hd) in v's dtype."""
    S, hd = q.shape[1], q.shape[-1]
    scale = torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32).to(q.dtype)
    kf, vf = k.float(), v.float()
    nq = max(1, min(q_chunk, S))
    outs = []
    for s0 in range(0, S, nq):
        qi = q[:, s0:s0 + nq] * scale
        s = torch.einsum("bqkgd,btkd->bkgqt", qi.float(), kf)
        if kv_mask is not None:
            s = s.masked_fill(~kv_mask[:, None, None, None, :], -1e30)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype).float(), vf)
        outs.append(o.to(v.dtype))
    return torch.cat(outs, dim=1)


def _attention(p, x, cfg: TransformerConfig, kv_mask) -> torch.Tensor:
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd = cfg.compute_dtype
    q = x @ p["wq"].to(cd)
    k = x @ p["wk"].to(cd)
    v = x @ p["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    out = _chunked_attention(q.reshape(B, S, KV, H // KV, hd),
                             k.reshape(B, S, KV, hd), v.reshape(B, S, KV, hd),
                             q_chunk=cfg.q_chunk, kv_mask=kv_mask)
    return out.reshape(B, S, H * hd) @ p["wo"].to(cd)


def _layer(p, x, cfg: TransformerConfig, kv_mask) -> torch.Tensor:
    cd = cfg.compute_dtype
    x = nn.layernorm(p["attn_norm"], x + _attention(p["attn"], x, cfg,
                                                    kv_mask), cfg.norm_eps)
    h = nn.gelu(nn.linear(p["mlp"]["w1"], x, cd))
    return nn.layernorm(p["mlp_norm"], x + nn.linear(p["mlp"]["w2"], h, cd),
                        cfg.norm_eps)


def _layer_params(stack, i: int):
    if isinstance(stack, dict):
        return {key: _layer_params(val, i) for key, val in stack.items()}
    return stack[i]


def forward(params, cfg: TransformerConfig, tokens: torch.Tensor,
            kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the trunk: tokens (B, S) -> hidden (B, S, D) in the compute
    dtype."""
    _check_encoder(cfg)
    S = tokens.shape[1]
    cd = cfg.compute_dtype
    x = nn.embedding(params["embed"], tokens, cd)
    positions = torch.arange(S, device=tokens.device)
    x = x + nn.embedding(params["pos_embed"], positions, cd)[None]
    stack = params["dense_layers"]
    for i in range(stack["attn"]["wq"].shape[0]):
        x = _layer(_layer_params(stack, i), x, cfg, kv_mask)
    return nn.layernorm(params["final_norm"], x, cfg.norm_eps)


def encode(params, cfg: TransformerConfig, tokens: torch.Tensor,
           mask: torch.Tensor, pooling: str = "mean") -> torch.Tensor:
    """Embed token sequences -> (B, D) L2-normalized f32 vectors (CLS or
    masked-mean pooling, as ``repro.models.transformer.encode``)."""
    hidden = forward(params, cfg, tokens, kv_mask=mask)
    if pooling == "cls":
        emb = hidden[:, 0]
    else:
        m = mask.to(hidden.dtype)[..., None]
        emb = (hidden * m).sum(1) / torch.clamp(m.sum(1), min=1e-6)
    emb = emb.float()
    return emb / torch.clamp(emb.norm(dim=-1, keepdim=True), min=1e-6)
