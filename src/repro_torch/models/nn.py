"""The functional layers the BERT trunk uses, on plain tensors.

Parameters are nested dicts of tensors with the JAX package's key names
(``repro/models/nn.py``), so a checkpoint of either package maps onto the
same tree.  Each function keeps the reference's dtype rules: weights are
cast to the compute dtype before the product, and layer norm runs in f32.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F


def to_torch_tree(tree: Any, device=None) -> Any:
    """Nested dicts of numpy arrays or tensors -> the same dicts of tensors
    on ``device``.  numpy bf16 leaves (``ml_dtypes.bfloat16``, as the JAX
    package's arrays convert) are taken bit for bit as ``torch.bfloat16``."""
    if isinstance(tree, dict):
        return {key: to_torch_tree(val, device) for key, val in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device) if device is not None else tree
    arr = np.asarray(tree)
    if not arr.flags.writeable:         # e.g. a view of a JAX array
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device) if device is not None else t


def linear(params, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    w = params["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ w
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def embedding(params, ids: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Row lookup; the rows are cast after the gather, which gives the same
    values as casting the table first."""
    rows = params["table"][ids]
    return rows.to(compute_dtype) if compute_dtype is not None else rows


def layernorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Layer norm computed in f32 and cast back to ``x``'s dtype."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")
