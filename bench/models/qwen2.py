"""Qwen2 (arXiv:2407.10671) as a bi-encoder trunk: pre-RMSNorm blocks of
grouped-query attention with RoPE and biased q/k/v, and a SwiGLU MLP;
causal attention over the text and a norm after the last layer."""

from __future__ import annotations

from typing import Dict, List

import torch

from bench.reference.encoders import (_attention, _mm, _rmsnorm, _rope,
                                      _widen)

#: the port's smoke-size qwen2, which the benchmark's CPU tests run
SMALL = dict(num_hidden_layers=2, hidden_size=56, num_attention_heads=7,
             num_key_value_heads=1, intermediate_size=96, vocab_size=211,
             rope_theta=10000.0)

_A, _M = "dense_layers/attn/", "dense_layers/mlp/"
MATRICES = (_A + "wq", _A + "wk", _A + "wv", _A + "wo",
            _M + "w1", _M + "w3", _M + "w2")

_ACTS = {"silu": "swiglu"}


def sizes(cfg: dict) -> dict:
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"L": cfg["num_hidden_layers"], "D": D, "H": H,
            "KV": cfg.get("num_key_value_heads", H),
            "hd": cfg.get("head_dim", D // H),
            "F": cfg["intermediate_size"], "V": cfg["vocab_size"]}


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
            ("final_norm/scale", (D,), "scale"),
            ("dense_layers/attn_norm/scale", (L, D), "scale"),
            ("dense_layers/mlp_norm/scale", (L, D), "scale"),
            (_M + "w1", (L, D, F), "matrix"),
            (_M + "w3", (L, D, F), "matrix"),
            (_M + "w2", (L, F, D), "matrix")]


def trunk(cfg: dict, W: Dict[str, torch.Tensor], tok: torch.Tensor,
          valid: torch.Tensor, precision: str) -> torch.Tensor:
    """Last hidden states (B, n, D) of one padded batch."""
    s = sizes(cfg)
    H, KV, hd = s["H"], s["KV"], s["hd"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    B, n = tok.shape
    x = W["embed/table"][tok].float()
    for l in range(s["L"]):
        def w(key):
            leaf = W[key][l]
            return _widen(leaf, precision) if key in MATRICES else leaf

        h = _rmsnorm(x, w("dense_layers/attn_norm/scale"), eps)
        q = (_mm(h, w(_A + "wq"), precision) + w(_A + "bq").float()) \
            .reshape(B, n, H, hd)
        k = (_mm(h, w(_A + "wk"), precision) + w(_A + "bk").float()) \
            .reshape(B, n, KV, hd)
        v = (_mm(h, w(_A + "wv"), precision) + w(_A + "bv").float()) \
            .reshape(B, n, KV, hd)
        q, k = _rope(q, theta), _rope(k, theta)
        x = x + _mm(_attention(q, k, v, valid, causal=True), w(_A + "wo"),
                    precision)
        h = _rmsnorm(x, w("dense_layers/mlp_norm/scale"), eps)
        f = torch.nn.functional.silu(_mm(h, w(_M + "w1"), precision)) \
            * _mm(h, w(_M + "w3"), precision)
        x = x + _mm(f, w(_M + "w2"), precision)
    return _rmsnorm(x, W["final_norm/scale"], eps)


def flops(cfg: dict, n_tokens: int) -> float:
    """Weight products, and causal attention over ``n (n + 1) / 2`` key
    positions; the SwiGLU MLP has three products."""
    s = sizes(cfg)
    D, F, n = s["D"], s["F"], int(n_tokens)
    Hd, KVd = s["H"] * s["hd"], s["KV"] * s["hd"]
    proj = 2 * n * D * (Hd + 2 * KVd) + 2 * n * Hd * D
    attn = 2 * 2 * (n * (n + 1) // 2) * Hd
    mlp = 2 * n * D * F * 3
    return float(s["L"] * (proj + attn + mlp))


def port_fields(cfg: dict) -> dict:
    s = sizes(cfg)
    return {"n_layers": s["L"], "d_model": s["D"], "n_heads": s["H"],
            "n_kv_heads": s["KV"], "head_dim": s["hd"], "d_ff": s["F"],
            "vocab_size": s["V"], "act": _ACTS[cfg["hidden_act"]],
            "norm_eps": cfg["rms_norm_eps"], "norm_style": "pre",
            "use_rope": True, "causal": True, "qkv_bias": True,
            "max_position_embeddings": 0, "rope_theta": cfg["rope_theta"]}
