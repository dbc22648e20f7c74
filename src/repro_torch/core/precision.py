"""Scoring precision as a measured fidelity axis (``repro/core/precision.py``).

:func:`chunk_scores` computes the ``(Q, rows)`` score block of the plain
PyTorch stage at every precision, with the kernels' arithmetic:

  * ``f32``  — a true f32 product (no TF32);
  * ``bf16`` — inputs rounded to bf16, products and sums in f32;
  * ``int8`` — symmetric per-row quantization (:func:`quantize_int8`), the
    exact integer products formed in float64, and the per-row scales folded
    in as ``(raw * q_scale) * c_scale`` before any mask or merge.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.topk_mips.ref import (SCORE_DTYPES, quantize_int8,
                                               scores_ref)

__all__ = ["SCORE_DTYPES", "quantize_int8", "validate_score_dtype",
           "chunk_scores", "quantize_rows_np"]


def validate_score_dtype(score_dtype: str) -> str:
    if score_dtype not in SCORE_DTYPES:
        raise ValueError(f"unknown score_dtype {score_dtype!r} "
                         f"(expected one of {SCORE_DTYPES})")
    return score_dtype


def chunk_scores(q_emb: torch.Tensor, emb: torch.Tensor,
                 score_dtype: str) -> torch.Tensor:
    """Scores for one chunk: (Q, D) x (rows, D) -> (Q, rows) f32."""
    return scores_ref(q_emb, emb, validate_score_dtype(score_dtype))


def quantize_rows_np(x):
    """Host-side twin of :func:`quantize_int8` (numpy in, numpy out; same
    formula, so the quantized images match)."""
    x = np.asarray(x, np.float32)
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    vals = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return vals, scale
