"""The functional layers of the transformer trunks, on plain tensors.

Parameters are nested dicts of tensors with the JAX package's key names
(``repro/models/nn.py``), so a checkpoint of either package maps onto the
same tree.  Each function keeps the reference's dtype rules: weights are
cast to the compute dtype before the product, and the norms and rotary
embeddings run in f32 and cast back.
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
        # np.require keeps a 0-d leaf 0-d (ascontiguousarray makes it 1-d)
        t = torch.from_numpy(
            np.require(arr, requirements="C").view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.require(arr, requirements="C"))
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


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in f32 and cast back to ``x``'s dtype."""
    dt = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * params["scale"].float()).to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def rope_frequencies(head_dim: int, theta: float = 10000.0) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), f32, on the CPU.

    The exponent is an f32 ``arange`` divided by ``head_dim`` and the result
    is ``1 / theta ** e`` in f32, as the reference computes it.  The power
    is rounded once to f32 from f64: that gives XLA's f32 ``pow`` bit for
    bit at every (head_dim, theta) of the configs, where torch's f32 ``pow``
    is one ulp off at (128, 1e6) — and an ulp of ``inv_freq`` moves the
    angle at position 2047 by ~2e-4 rad.  Computed on the CPU so every
    device uses the same values."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    return 1.0 / (theta ** exponent.double()).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding of x (..., seq, n_heads, head_dim) at ``positions``
    (broadcastable to (..., seq)).  Dimension d pairs with d + head_dim/2
    (the "rotate_half" convention); angles and products in f32."""
    inv_freq = rope_frequencies(x.shape[-1], theta).to(x.device)
    angles = positions[..., None].float() * inv_freq       # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]             # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
