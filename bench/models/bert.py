"""BERT (arXiv:1810.04805) as the port's dr-bert-base builds it: post-LN
blocks of bidirectional attention with learned positions and a GELU MLP,
with the configuration's ``departures`` (tanh GELU, no segment table, no
bias on the attention's output, a norm after the last layer and none on
the embeddings)."""

from __future__ import annotations

from typing import Dict, List

import torch

from bench.reference.encoders import (_attention, _gelu_tanh, _layernorm,
                                      _mm, _widen)

#: the port's smoke-size dr-bert-base, which the benchmark's CPU tests run
SMALL = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
             intermediate_size=128, vocab_size=211,
             max_position_embeddings=64)

_A, _M = "dense_layers/attn/", "dense_layers/mlp/"
MATRICES = (_A + "wq", _A + "wk", _A + "wv", _A + "wo",
            _M + "w1/w", _M + "w2/w")

_ACTS = {"gelu_pytorch_tanh": "gelu"}


def sizes(cfg: dict) -> dict:
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"L": cfg["num_hidden_layers"], "D": D, "H": H,
            "KV": cfg.get("num_key_value_heads", H),
            "hd": cfg.get("head_dim", D // H),
            "F": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "P": cfg["max_position_embeddings"]}


def layout(cfg: dict) -> List[tuple]:
    s = sizes(cfg)
    L, D, F = s["L"], s["D"], s["F"]
    Hd, KVd = s["H"] * s["hd"], s["KV"] * s["hd"]
    return [("embed/table", (s["V"], D), "table"),
            (_A + "wq", (L, D, Hd), "matrix"),
            (_A + "wk", (L, D, KVd), "matrix"),
            (_A + "wv", (L, D, KVd), "matrix"),
            (_A + "wo", (L, Hd, D), "matrix"),
            (_A + "bq", (L, Hd), "bias"), (_A + "bk", (L, KVd), "bias"),
            (_A + "bv", (L, KVd), "bias"),
            ("pos_embed/table", (s["P"], D), "table"),
            ("final_norm/scale", (D,), "scale"),
            ("final_norm/bias", (D,), "bias"),
            ("dense_layers/attn_norm/scale", (L, D), "scale"),
            ("dense_layers/attn_norm/bias", (L, D), "bias"),
            ("dense_layers/mlp_norm/scale", (L, D), "scale"),
            ("dense_layers/mlp_norm/bias", (L, D), "bias"),
            (_M + "w1/w", (L, D, F), "matrix"),
            (_M + "w1/b", (L, F), "bias"),
            (_M + "w2/w", (L, F, D), "matrix"),
            (_M + "w2/b", (L, D), "bias"),
            # the port's BERT trunk keeps an untied LM head, which its
            # checkpoints carry and its encoder never reads
            ("lm_head/w", (D, s["V"]), "matrix")]


def trunk(cfg: dict, W: Dict[str, torch.Tensor], tok: torch.Tensor,
          valid: torch.Tensor, precision: str) -> torch.Tensor:
    """Last hidden states (B, n, D) of one padded batch."""
    s = sizes(cfg)
    H, KV, hd = s["H"], s["KV"], s["hd"]
    eps = cfg["layer_norm_eps"]
    B, n = tok.shape
    x = W["embed/table"][tok].float() + W["pos_embed/table"][:n].float()[None]
    for l in range(s["L"]):
        def w(key):
            leaf = W[key][l]
            return _widen(leaf, precision) if key in MATRICES else leaf

        q = (_mm(x, w(_A + "wq"), precision) + w(_A + "bq").float()) \
            .reshape(B, n, H, hd)
        k = (_mm(x, w(_A + "wk"), precision) + w(_A + "bk").float()) \
            .reshape(B, n, KV, hd)
        v = (_mm(x, w(_A + "wv"), precision) + w(_A + "bv").float()) \
            .reshape(B, n, KV, hd)
        o = _mm(_attention(q, k, v, valid, causal=False), w(_A + "wo"),
                precision)
        x = _layernorm(x + o, w("dense_layers/attn_norm/scale"),
                       w("dense_layers/attn_norm/bias"), eps)
        f = _gelu_tanh(_mm(x, w(_M + "w1/w"), precision)
                       + w(_M + "w1/b").float())
        f = _mm(f, w(_M + "w2/w"), precision) + w(_M + "w2/b").float()
        x = _layernorm(x + f, w("dense_layers/mlp_norm/scale"),
                       w("dense_layers/mlp_norm/bias"), eps)
    return _layernorm(x, W["final_norm/scale"], W["final_norm/bias"], eps)


def flops(cfg: dict, n_tokens: int) -> float:
    """Weight products, and bidirectional attention over ``n ** 2`` key
    positions; the GELU MLP has two products."""
    s = sizes(cfg)
    D, F, n = s["D"], s["F"], int(n_tokens)
    Hd, KVd = s["H"] * s["hd"], s["KV"] * s["hd"]
    proj = 2 * n * D * (Hd + 2 * KVd) + 2 * n * Hd * D
    attn = 2 * 2 * (n * n) * Hd
    mlp = 2 * n * D * F * 2
    return float(s["L"] * (proj + attn + mlp))


def port_fields(cfg: dict) -> dict:
    s = sizes(cfg)
    return {"n_layers": s["L"], "d_model": s["D"], "n_heads": s["H"],
            "n_kv_heads": s["KV"], "head_dim": s["hd"], "d_ff": s["F"],
            "vocab_size": s["V"], "act": _ACTS[cfg["hidden_act"]],
            "norm_eps": cfg["layer_norm_eps"], "norm_style": "post",
            "use_rope": False, "causal": False, "qkv_bias": True,
            "max_position_embeddings": s["P"]}
