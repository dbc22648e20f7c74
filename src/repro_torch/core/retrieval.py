"""Exact MIPS top-k retrieval and candidate reranking (``repro/core/retrieval.py``).

The materialized engine's scoring, on the device its embeddings live on:

  * :func:`topk_exact`    — plain PyTorch: corpus blocks scored one at a
                            time and folded into a running ``(Q, k)`` top-k
                            with a stable merge, so the ``(Q, N)`` score
                            matrix never exists.
  * :func:`retrieve_run`  — a ``{qid: [docid, ...]}`` run from embeddings:
                            ``impl="cuda"`` calls the hand-written topk_mips
                            kernels on the whole corpus
                            (:func:`repro_torch.kernels.topk_mips.ops.
                            topk_mips`), ``impl="torch"`` calls
                            :func:`topk_exact`.
  * :func:`rerank_run`    — RocketQA-style rerank: score only each query's
                            candidate list, one query block at a time, and
                            select through :func:`rank_candidates`, the
                            stable selection the streaming rerank stage
                            finalizes through as well.

The sharded retrieval of the reference (``topk_sharded``) is not ported
yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.precision import (chunk_scores, quantize_int8,
                                        validate_score_dtype)
from repro_torch.kernels.topk_mips.ref import select_topk

Run = Dict[str, List[str]]
Scores = Dict[str, List[float]]

#: retrieve_run impls: plain PyTorch, or the topk_mips kernels
_IMPLS = ("torch", "cuda")


def _merge_topk(scores_a, idx_a, scores_b, idx_b, k: int):
    """Merge two (Q, ka) / (Q, kb) candidate sets into (Q, k): descending,
    and on equal scores ``a`` first, then the lower position."""
    return select_topk(torch.cat([scores_a, scores_b], dim=1),
                       torch.cat([idx_a, idx_b], dim=1), k)


def topk_exact(q_emb: torch.Tensor, c_emb: torch.Tensor, *, k: int,
               block: int = 4096, score_dtype: str = "f32"):
    """q_emb (Q, D) x c_emb (N, D) -> (scores (Q, k) f32, indices (Q, k)
    int32), ``k`` cut to N.

    Corpus blocks of ``block`` rows are scored at ``score_dtype`` (per-row
    quantization, so a block's scores do not depend on the block size) and
    merged into the running top-k, the carry first: on equal scores the
    earlier corpus row wins, as ``lax.top_k`` orders the reference's."""
    validate_score_dtype(score_dtype)
    Q = q_emb.shape[0]
    N = c_emb.shape[0]
    k = min(k, N)
    nb = max(1, min(block, N))
    run_s = torch.full((Q, k), float("-inf"), device=q_emb.device)
    run_i = torch.zeros((Q, k), dtype=torch.int32, device=q_emb.device)
    for b0 in range(0, N, nb):
        s = chunk_scores(q_emb, c_emb[b0:b0 + nb], score_dtype)
        idx = torch.arange(b0, b0 + s.shape[1], dtype=torch.int32,
                           device=s.device).expand(Q, -1)
        run_s, run_i = _merge_topk(run_s, run_i, s, idx, k)
    return run_s, run_i


def _as_tensor(x, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(x, np.float32)))
    return t.to(device) if device is not None else t


def retrieve_run(query_ids: Sequence[str], q_emb, doc_ids: Sequence[str],
                 c_emb, *, k: int, impl: str = "torch", block: int = 4096,
                 score_dtype: str = "f32"):
    """Build a ``{qid: [docid, ...]}`` run and its scores from embeddings,
    scored on ``c_emb``'s device.  ``impl="cuda"`` is one call of the
    topk_mips kernels over the whole corpus (its plain version for CPU
    tensors); ``impl="torch"`` is :func:`topk_exact`."""
    validate_score_dtype(score_dtype)
    if impl not in _IMPLS:
        raise ValueError(f"unknown retrieval impl {impl!r} "
                         f"(expected one of {_IMPLS})")
    c = _as_tensor(c_emb)
    q = _as_tensor(q_emb, c.device)
    if impl == "cuda":
        from repro_torch.kernels.topk_mips import ops as mips_ops
        scores, idx = mips_ops.topk_mips(q.contiguous(), c.contiguous(),
                                         k=k, score_dtype=score_dtype)
    else:
        scores, idx = topk_exact(q, c, k=k, block=block,
                                 score_dtype=score_dtype)
    scores = scores.cpu().numpy()
    idx = idx.cpu().numpy()
    run, run_scores = {}, {}
    for qi, qid in enumerate(query_ids):
        run[qid] = [doc_ids[j] for j in idx[qi]]
        run_scores[qid] = [float(s) for s in scores[qi]]
    return run, run_scores


def pad_candidates(query_ids, doc_ids, per_query: dict):
    """Per-query candidate lists -> a padded (Q, Cmax) matrix of corpus row
    positions (-1 = padding), plus the filtered candidate id lists."""
    doc_pos = {d: i for i, d in enumerate(doc_ids)}
    cands = [[d for d in per_query.get(qid, []) if d in doc_pos]
             for qid in query_ids]
    c_max = max((len(c) for c in cands), default=0)
    idx = np.full((len(query_ids), max(c_max, 1)), -1, np.int32)
    for qi, row in enumerate(cands):
        idx[qi, :len(row)] = [doc_pos[d] for d in row]
    return idx, cands


def rank_candidates(query_ids, s, cands, *, k: int):
    """Candidate-score matrix -> ({qid: [docid...]}, {qid: [score...]}).

    The one selection routine every rerank path finalizes through: a
    *stable* descending sort of the (Q, Cmax) score matrix, keeping the top
    ``min(k, len(cands[q]))`` slots per query.  Duplicate doc ids (and any
    other exact ties) resolve to the lower candidate slot whichever path
    produced the matrix, so identical matrices give identical runs.  Pad
    slots are ``-inf`` and are fenced off by the per-query candidate count,
    so a ``k`` larger than the list never surfaces a pad."""
    s = s.detach().cpu().numpy() if isinstance(s, torch.Tensor) \
        else np.asarray(s)
    order = np.argsort(-s, axis=1, kind="stable")
    run, run_scores = {}, {}
    for qi, qid in enumerate(query_ids):
        keep = order[qi, :min(k, len(cands[qi]))]
        run[qid] = [cands[qi][j] for j in keep]
        run_scores[qid] = [float(s[qi, j]) for j in keep]
    return run, run_scores


# default per-block candidate-gather budget for the materialized rerank path
RERANK_BLOCK_BYTES = 256 << 20


def quantize_values(x: torch.Tensor, score_dtype: str) -> torch.Tensor:
    """Value-level quantization for the rerank path (the reference's
    ``_quantize_values_np``): the f32 tensor whose entries are exactly what
    the retrieval kernels score at ``score_dtype`` — bf16 is a round trip
    through bf16 (a bf16 x bf16 product is exact in f32), int8 is the
    dequantized per-row symmetric quantization, ``values * scale`` in f32."""
    if score_dtype == "bf16":
        return x.to(torch.bfloat16).float()
    if score_dtype == "int8":
        vals, scale = quantize_int8(x)
        return vals.float() * scale
    raise ValueError(f"unexpected score_dtype {score_dtype!r}")


def fixed_order_dots(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(B, C, D) candidate rows x (B, D) queries -> (B, C) dot products in
    f32, each summed over D by one fixed pairwise tree of elementwise adds
    (D zero-padded to a power of two).  A product's value then depends on
    nothing but its two vectors: not on how many queries or candidates are
    computed together, nor on the device (a GEMM's summation order may
    change with its shape, which would let the query block change a run)."""
    p = rows * q[:, None, :]
    n = p.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        p = torch.nn.functional.pad(p, (0, width - n))
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    return p[..., 0]


def rerank_block_rows(q_block: Optional[int], *, n_queries: int, c_max: int,
                      dim: int, block_bytes: int = RERANK_BLOCK_BYTES) -> int:
    """Queries per candidate gather: ``q_block`` when given, else as many
    as fit one ``(Q_block, Cmax, D)`` f32 gather into ``block_bytes``;
    clamped to [1, Q]."""
    if q_block is None:
        row_bytes = c_max * dim * 4
        q_block = int(max(1, block_bytes // max(row_bytes, 1)))
    return max(1, min(int(q_block), n_queries))


@torch.inference_mode()
def rerank_run(query_ids, q_emb, doc_ids, c_emb, per_query: dict, *, k: int,
               q_block: Optional[int] = None,
               block_bytes: int = RERANK_BLOCK_BYTES,
               score_dtype: str = "f32"):
    """Rerank validation: score only each query's candidate list (no global
    top-k), on ``c_emb``'s device.

    The candidate embeddings are gathered one query block at a time,
    ``(Q_block, Cmax, D)`` per gather followed by one batched product, so
    peak gather memory is ``O(Q_block x Cmax x D)``.  ``q_block`` pins the
    block height; ``None`` sizes it from ``block_bytes``
    (:func:`rerank_block_rows`).  Each (q, c) product is summed by
    :func:`fixed_order_dots`, the same way at every block height and on
    every device, so runs and scores do not depend on the block.
    ``score_dtype`` quantizes the embeddings at value level first
    (:func:`quantize_values`); products and sums stay f32.  Selection is
    :func:`rank_candidates`."""
    validate_score_dtype(score_dtype)
    c = _as_tensor(c_emb)
    q = _as_tensor(q_emb, c.device)
    if score_dtype != "f32":
        q = quantize_values(q, score_dtype)
        c = quantize_values(c, score_dtype)
    q, c = q.float(), c.float()
    cand_idx, cands = pad_candidates(query_ids, doc_ids, per_query)
    valid = cand_idx >= 0
    if not valid.any():
        return {qid: [] for qid in query_ids}, {qid: [] for qid in query_ids}
    Q, c_max = cand_idx.shape
    q_block = rerank_block_rows(q_block, n_queries=Q, c_max=c_max,
                                dim=c.shape[-1], block_bytes=block_bytes)
    device = c.device
    valid_t = torch.from_numpy(valid).to(device)
    clipped = torch.from_numpy(
        np.clip(cand_idx, 0, max(len(doc_ids) - 1, 0)).astype(np.int64)
    ).to(device)
    s = torch.full((Q, c_max), float("-inf"), device=device)
    for b0 in range(0, Q, q_block):
        b1 = min(b0 + q_block, Q)
        sub = c[clipped[b0:b1]]                       # (Q_block, Cmax, D)
        sb = fixed_order_dots(sub, q[b0:b1])          # (Q_block, Cmax)
        s[b0:b1] = torch.where(valid_t[b0:b1], sb, float("-inf"))
    return rank_candidates(query_ids, s, cands, k=k)
