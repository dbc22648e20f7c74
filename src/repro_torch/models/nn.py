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


_FREQ_CACHE = {}


def _device_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """:func:`rope_frequencies` on ``device``, copied there once: a copy
    from host memory on every call would wait for the card's queue to
    drain (twice a layer).  Made outside inference mode, so an autograd
    pass may read the tensor that a serving call cached."""
    key = (head_dim, float(theta), torch.device(device))
    freqs = _FREQ_CACHE.get(key)
    if freqs is None:
        with torch.inference_mode(False):
            freqs = rope_frequencies(head_dim, theta).to(device)
        _FREQ_CACHE[key] = freqs
    return freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding of x (..., seq, n_heads, head_dim) at ``positions``
    (broadcastable to (..., seq)).  Dimension d pairs with d + head_dim/2
    (the "rotate_half" convention); angles and products in f32."""
    inv_freq = _device_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * inv_freq       # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]             # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def unstack(stack, n: int):
    """The ``n`` per-layer trees of views of the stacked ``(L, ...)``
    leaves.  Each leaf is unbound once, so under autograd its gradient is
    assembled by one ``stack``, where indexing each layer's slice would
    build and add a zero-filled ``(L, ...)`` gradient per layer."""
    if isinstance(stack, dict):
        per_key = {key: unstack(val, n) for key, val in stack.items()}
        return [{key: per_key[key][i] for key in stack} for i in range(n)]
    return stack.unbind(0)


# ---------------------------------------------------------------------------
# Random parameters from a seed, and segment reductions
# ---------------------------------------------------------------------------

#: leaf names the reference's inits fill with zeros (norm scales: ones)
ZERO_LEAVES = ("bias", "b", "bq", "bk", "bv")


def init_numpy(shapes, seed: int, std) -> Any:
    """Random parameters for a tree of leaf shapes, as nested dicts of
    numpy f32 arrays drawn from ``numpy.random.default_rng(seed)`` in
    sorted-key order: leaves named ``scale`` are ones, those in
    :data:`ZERO_LEAVES` zeros, and every other leaf N(0, ``std(name,
    shape)``), ``name`` being the leaf's key."""
    rng = np.random.default_rng(seed)

    def build(node, name):
        if isinstance(node, dict):
            return {key: build(node[key], key) for key in sorted(node)}
        if name == "scale":
            return np.ones(node, np.float32)
        if name in ZERO_LEAVES:
            return np.zeros(node, np.float32)
        return rng.standard_normal(node, dtype=np.float32) \
            * np.float32(std(name, node))

    return build(shapes, "")


def fan_in_std(shape) -> float:
    """1/sqrt(fan_in), fan_in being the second-to-last axis: the input
    axis of a product weight, stacked or not (the reference's
    ``fanin_init``)."""
    return 1.0 / np.sqrt(shape[-2])


def _segments(segment_ids: torch.Tensor, num_segments: int):
    """The stable order that sorts ``segment_ids``, and each segment's
    length, found on the ids' device (no size read back to the host)."""
    order = torch.argsort(segment_ids, stable=True)
    bounds = torch.searchsorted(
        segment_ids[order],
        torch.arange(num_segments + 1, device=segment_ids.device))
    return order, bounds.diff()


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` for ids in ``[0, num_segments)``: rows of
    ``data`` (n, ...) summed per segment, empty segments 0.  The rows are
    sorted stably by segment and each segment is summed in that order by
    ``torch.segment_reduce``, so the result does not depend on the run (a
    scatter-add on a card does)."""
    order, lengths = _segments(segment_ids, num_segments)
    return torch.segment_reduce(data[order], "sum", lengths=lengths,
                                initial=0, unsafe=True)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max`` for ids in ``[0, num_segments)``: empty
    segments are ``-inf``, as the reference's."""
    order, lengths = _segments(segment_ids, num_segments)
    return torch.segment_reduce(data[order], "max", lengths=lengths,
                                unsafe=True)
