"""Peaks of the chip and the operations and bytes of the work, counted
from its shapes, whatever implements it.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), at
its full 700 W; the run prints the card's power limit beside them.
Model FLOPs count each multiply-add as 2 operations: the trunk's weight
products and the attention's two products over real tokens (a causal
trunk attends to ``n (n + 1) / 2`` key positions, a bidirectional one to
``n ** 2``), as each trunk's module (``bench/models/``) counts them;
norms, activations, softmax and pooling are not counted.
"""

from __future__ import annotations

from typing import Iterable

from bench import models

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12


def encoder_flops(cfg: dict, n_tokens: int) -> float:
    """Forward FLOPs of the trunk over one sequence of ``n_tokens``."""
    return float(models.of(cfg).flops(cfg, n_tokens))


def encode_flops(cfg: dict, lengths: Iterable[int]) -> float:
    flops = models.of(cfg).flops
    return float(sum(flops(cfg, n) for n in lengths))


def score_flops(n_queries: int, n_rows: int, dim: int) -> float:
    """An exhaustive inner-product search: ``2 Q N D``."""
    return 2.0 * n_queries * n_rows * dim


def search_bytes(n_queries: int, n_rows: int, dim: int, k: int,
                 elem: int = 4) -> float:
    """Each input byte read once (the rows, the queries) and each output
    byte written once (``k`` f32 scores and int32 ids a query)."""
    return float(n_rows * dim * elem + n_queries * dim * 4
                 + n_queries * k * 8)


def search_bound_s(n_queries: int, n_rows: int, dim: int, k: int) -> dict:
    """The least time an f32 search could take: the larger of its FLOPs at
    the f32 rate and its bytes at the HBM rate."""
    ops = score_flops(n_queries, n_rows, dim) / PEAK_F32_FLOPS
    mem = search_bytes(n_queries, n_rows, dim, k) / PEAK_HBM_BYTES
    return {"s": max(ops, mem), "by": "bytes" if mem >= ops else "flops",
            "flops_s": ops, "bytes_s": mem}
