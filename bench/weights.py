"""Checkpoint layouts and seeded weights, made on the device.

A configuration file names a ``model_type``; :func:`layout` gives the
parameter tree of that type as the port's checkpoints hold it (the key
paths of its checkpoint format, with stacked ``(L, ...)`` layer leaves).
The benchmark's reference reads the same layout, so both sides get one
tree of weights.

:func:`draw` makes every leaf from the seed in one ``torch.randn`` call
on the device, in the dtype the configuration stores, and cuts the flat
buffer into views: tables N(0, 0.02), matrices N(0, 1/fan_in), norm
scales 1 + N(0, 0.05), biases N(0, 0.02).  Non-trivial scales and biases
keep those paths of the trunk in the comparison.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bench import gen

Leaf = Tuple[str, Tuple[int, ...], str]     # (key path, shape, kind)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def sizes(cfg: dict) -> dict:
    """The sizes a layout and a FLOP count need, from a config file."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = cfg.get("head_dim", D // H)
    return {"L": cfg["num_hidden_layers"], "D": D, "H": H,
            "KV": cfg.get("num_key_value_heads", H), "hd": hd,
            "F": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "P": cfg.get("max_position_embeddings", 0)}


def layout(cfg: dict) -> List[Leaf]:
    s = sizes(cfg)
    L, D, F, V = s["L"], s["D"], s["F"], s["V"]
    Hd, KVd = s["H"] * s["hd"], s["KV"] * s["hd"]
    a = "dense_layers/attn/"
    m = "dense_layers/mlp/"
    leaves: List[Leaf] = [("embed/table", (V, D), "table")]
    leaves += [(a + "wq", (L, D, Hd), "matrix"),
               (a + "wk", (L, D, KVd), "matrix"),
               (a + "wv", (L, D, KVd), "matrix"),
               (a + "wo", (L, Hd, D), "matrix"),
               (a + "bq", (L, Hd), "bias"), (a + "bk", (L, KVd), "bias"),
               (a + "bv", (L, KVd), "bias")]
    if cfg["model_type"] == "bert":
        leaves += [("pos_embed/table", (s["P"], D), "table"),
                   ("final_norm/scale", (D,), "scale"),
                   ("final_norm/bias", (D,), "bias"),
                   ("dense_layers/attn_norm/scale", (L, D), "scale"),
                   ("dense_layers/attn_norm/bias", (L, D), "bias"),
                   ("dense_layers/mlp_norm/scale", (L, D), "scale"),
                   ("dense_layers/mlp_norm/bias", (L, D), "bias"),
                   (m + "w1/w", (L, D, F), "matrix"),
                   (m + "w1/b", (L, F), "bias"),
                   (m + "w2/w", (L, F, D), "matrix"),
                   (m + "w2/b", (L, D), "bias"),
                   # the port's BERT trunk keeps an untied LM head, which
                   # its checkpoints carry and its encoder never reads
                   ("lm_head/w", (D, V), "matrix")]
    elif cfg["model_type"] == "qwen2":
        leaves += [("final_norm/scale", (D,), "scale"),
                   ("dense_layers/attn_norm/scale", (L, D), "scale"),
                   ("dense_layers/mlp_norm/scale", (L, D), "scale"),
                   (m + "w1", (L, D, F), "matrix"),
                   (m + "w3", (L, D, F), "matrix"),
                   (m + "w2", (L, F, D), "matrix")]
    else:
        raise ValueError(f"no layout for model_type {cfg['model_type']!r}")
    return leaves


def n_params(cfg: dict) -> int:
    total = 0
    for _, shape, _ in layout(cfg):
        n = 1
        for d in shape:
            n *= d
        total += n
    return total


def draw(cfg: dict, seed: int, tag: int, device) -> Dict[str, torch.Tensor]:
    """``{key path: tensor}`` of one checkpoint's weights, on ``device``."""
    dtype = DTYPES[cfg["torch_dtype"]]
    g = torch.Generator(device=device)
    g.manual_seed(gen.torch_seed(seed, 10, tag))
    flat = torch.randn(n_params(cfg), generator=g, dtype=dtype,
                       device=device)
    out, at = {}, 0
    for path, shape, kind in layout(cfg):
        n = 1
        for d in shape:
            n *= d
        leaf = flat[at:at + n].view(shape)
        at += n
        if kind == "table":
            leaf.mul_(0.02)
        elif kind == "matrix":
            leaf.mul_(shape[-2] ** -0.5)
        elif kind == "scale":
            leaf.mul_(0.05).add_(1.0)
        else:
            leaf.mul_(0.02)
        out[path] = leaf
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree
