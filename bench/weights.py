"""Checkpoint layouts and seeded weights, made on the device.

The trunk's module (``bench/models/<model_type>.py``) gives the
parameter tree as the port's checkpoints hold it (the key paths of its
checkpoint format, with stacked ``(L, ...)`` layer leaves).  The
benchmark's reference reads the same layout, so both sides get one tree
of weights.

:func:`draw` makes every leaf from the seed in one ``torch.randn`` call
on the device, in the dtype the configuration stores, and cuts the flat
buffer into views: tables N(0, 0.02), matrices N(0, 1/fan_in), norm
scales 1 + N(0, 0.05), biases N(0, 0.02).  Non-trivial scales and biases
keep those paths of the trunk in the comparison.
"""

from __future__ import annotations

from typing import Dict

import torch

from bench import gen, models

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def n_params(cfg: dict) -> int:
    total = 0
    for _, shape, _ in models.of(cfg).layout(cfg):
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
    for path, shape, kind in models.of(cfg).layout(cfg):
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
