"""Exact search and the IR metrics, in plain PyTorch and Python."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

Run = Dict[str, List[str]]
Qrels = Dict[str, Dict[str, int]]


def exact_topk(scores: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of each row, descending; the lower position wins a tie."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def merge_topk(vals: torch.Tensor, idx: torch.Tensor, new_vals, new_idx,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a block's candidates into a running top ``k`` (positions
    ascend across blocks, so the earlier block wins a tie)."""
    v = torch.cat([vals, new_vals], dim=1)
    i = torch.cat([idx, new_idx], dim=1)
    order = torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(v, 1, order), torch.gather(i, 1, order)


def _relevant(qrels: Qrels, qid: str) -> set:
    return {d for d, g in qrels.get(qid, {}).items() if g > 0}


def mrr(run: Run, qrels: Qrels, k: int) -> float:
    """Mean reciprocal rank of the first relevant passage in the top
    ``k``, over the queries that have one in the qrels."""
    total, n = 0.0, 0
    for qid, docs in run.items():
        rel = _relevant(qrels, qid)
        if not rel:
            continue
        n += 1
        for rank, d in enumerate(docs[:k], start=1):
            if d in rel:
                total += 1.0 / rank
                break
    return total / max(n, 1)


def recall(run: Run, qrels: Qrels, k: int) -> float:
    """Share of each query's relevant passages in its top ``k``, averaged
    over the queries that have one."""
    total, n = 0.0, 0
    for qid, docs in run.items():
        rel = _relevant(qrels, qid)
        if not rel:
            continue
        n += 1
        total += len(rel.intersection(docs[:k])) / len(rel)
    return total / max(n, 1)


def metric(name: str, run: Run, qrels: Qrels) -> float:
    kind, k = name.split("@")
    if kind == "MRR":
        return mrr(run, qrels, int(k))
    if kind == "Recall":
        return recall(run, qrels, int(k))
    raise ValueError(f"the reference has no metric {name!r}")


def subset_ids(corpus_ids: Sequence[str], run: Dict[str, list],
               qrels: Qrels, depth: int) -> List[str]:
    """The paper's validation subset: every relevant passage and each
    query's top ``depth`` of the baseline run, in sorted id order."""
    keep = {d for q in qrels.values() for d, g in q.items() if g > 0}
    for ranked in run.values():
        keep.update(d for d, _ in ranked[:depth])
    return sorted(keep & set(corpus_ids))
