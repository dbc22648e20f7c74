"""Sparse embedding ops for the recommenders (``repro/models/
embedding_ops.py`` in PyTorch): table init, hashing, lookup, EmbeddingBag
and the dense multi-hot bag.

``embedding_bag`` is a gather and a segment reduction
(:func:`repro_torch.models.nn.segment_sum` / ``segment_max``), as the
reference's ``jnp.take`` + ``jax.ops.segment_sum``; the reductions sum each
bag in a fixed order, so a bag's value does not depend on the run.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import nn

_U32 = 0xFFFFFFFF
_HASH_MULT = 2654435761


def embedding_table_init(rng: np.random.Generator, n_rows: int, dim: int,
                         stddev: float = 0.02) -> np.ndarray:
    """An (n_rows, dim) f32 table drawn N(0, stddev) from ``rng``."""
    return rng.standard_normal((n_rows, dim), dtype=np.float32) \
        * np.float32(stddev)


def hash_bucket(ids: torch.Tensor, n_rows: int, salt: int = 0
                ) -> torch.Tensor:
    """The reference's multiplicative hash into ``[0, n_rows)``, bit for
    bit: its uint32 arithmetic done in int64 and masked to 32 bits.  The
    product by the 32-bit multiplier is split in two 16-bit halves of the
    id so no partial product leaves int64."""
    h = (ids.long() + salt) & _U32
    lo, hi = h & 0xFFFF, h >> 16
    h = (lo * _HASH_MULT + (((hi * _HASH_MULT) & 0xFFFF) << 16)) & _U32
    h = h ^ (h >> 16)
    return (h % n_rows).to(torch.int32)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     compute_dtype=None) -> torch.Tensor:
    """Rows ``ids`` of ``table``, cast after the gather (the same values as
    the reference's cast of the whole table first)."""
    rows = table[ids.long()]
    return rows if compute_dtype is None else rows.to(compute_dtype)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  segment_ids: torch.Tensor, num_segments: int, *,
                  mode: str = "sum", weights=None, valid=None,
                  compute_dtype=None) -> torch.Tensor:
    """``torch.nn.EmbeddingBag`` as the reference computes it.

    ids (nnz,) row indices; segment_ids (nnz,) bag of each (any order, in
    ``[0, num_segments)``); valid (nnz,) bool for padding entries; weights
    per-id scales (weighted-sum bags).  Returns (num_segments, dim); an
    empty bag is 0 in every mode."""
    if mode not in ("sum", "mean", "max"):
        raise ValueError(mode)
    vecs = embedding_lookup(table, ids, compute_dtype)
    seg = segment_ids.long()
    if weights is not None:
        vecs = vecs * weights[:, None].to(vecs.dtype)
    if valid is not None:
        if mode == "max":
            vecs = vecs.masked_fill(~valid[:, None], float("-inf"))
        else:
            vecs = vecs * valid[:, None].to(vecs.dtype)
    if mode == "max":
        out = nn.segment_max(vecs, seg, num_segments)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    s = nn.segment_sum(vecs, seg, num_segments)
    if mode == "sum":
        return s
    ones = valid.to(vecs.dtype) if valid is not None else \
        torch.ones(ids.shape[0], dtype=vecs.dtype, device=vecs.device)
    c = nn.segment_sum(ones, seg, num_segments)
    return s / torch.clamp(c[:, None], min=1e-9)


def multi_hot_bag(table: torch.Tensor, ids: torch.Tensor,
                  valid: torch.Tensor, *, mode: str = "sum",
                  compute_dtype=None) -> torch.Tensor:
    """Dense-layout EmbeddingBag: ids and valid (B, F, max_hot) -> (B, F,
    dim), one bag per (example, field), the layout of recsys batches."""
    B, F, M = ids.shape
    flat = embedding_lookup(table, ids.reshape(-1), compute_dtype)
    flat = flat.reshape(B, F, M, -1)
    v = valid[..., None].to(flat.dtype)
    if mode == "sum":
        return (flat * v).sum(dim=2)
    if mode == "mean":
        return (flat * v).sum(dim=2) / torch.clamp(v.sum(dim=2), min=1e-9)
    if mode == "max":
        out = flat.masked_fill(~valid[..., None], float("-inf")).amax(dim=2)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    raise ValueError(mode)
