"""IR evaluation metrics for checkpoint validation (paper §3 ``--metrics``).

A *run* is ``{qid: [docid, ...]}`` (rank order); *qrels* is
``{qid: {docid: gain}}`` (TREC format, gain >= 1 means relevant).

Supported metric strings (paper default is MRR@10 on MS MARCO):
  MRR@k, Recall@k, nDCG@k, Success@k, AverageRank (the DPR §2 strategy:
  mean rank of the first gold within the candidate pool; lower = better).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List

Run = Dict[str, List[str]]
Qrels = Dict[str, Dict[str, int]]

_METRIC_RE = re.compile(r"^(MRR|Recall|nDCG|Success)@(\d+)$|^(AverageRank)$")


def parse_metric(name: str):
    m = _METRIC_RE.match(name)
    if not m:
        raise ValueError(f"unknown metric {name!r}")
    if m.group(3):
        return ("AverageRank", None)
    return (m.group(1), int(m.group(2)))


def _relevant(qrels: Qrels, qid: str) -> set:
    return {d for d, g in qrels.get(qid, {}).items() if g > 0}


def mrr_at_k(run: Run, qrels: Qrels, k: int) -> float:
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


def recall_at_k(run: Run, qrels: Qrels, k: int) -> float:
    total, n = 0.0, 0
    for qid, docs in run.items():
        rel = _relevant(qrels, qid)
        if not rel:
            continue
        n += 1
        total += len(rel.intersection(docs[:k])) / len(rel)
    return total / max(n, 1)


def success_at_k(run: Run, qrels: Qrels, k: int) -> float:
    total, n = 0.0, 0
    for qid, docs in run.items():
        rel = _relevant(qrels, qid)
        if not rel:
            continue
        n += 1
        total += 1.0 if rel.intersection(docs[:k]) else 0.0
    return total / max(n, 1)


def ndcg_at_k(run: Run, qrels: Qrels, k: int) -> float:
    total, n = 0.0, 0
    for qid, docs in run.items():
        gains = qrels.get(qid, {})
        if not any(g > 0 for g in gains.values()):
            continue
        n += 1
        dcg = sum((2 ** gains.get(d, 0) - 1) / math.log2(r + 1)
                  for r, d in enumerate(docs[:k], start=1))
        ideal = sorted((g for g in gains.values() if g > 0), reverse=True)[:k]
        idcg = sum((2 ** g - 1) / math.log2(r + 1)
                   for r, g in enumerate(ideal, start=1))
        total += dcg / idcg if idcg > 0 else 0.0
    return total / max(n, 1)


def average_rank(run: Run, qrels: Qrels) -> float:
    """DPR-style: mean rank (1-based) of the first relevant doc; queries whose
    gold is absent from the candidate list count as rank len(list)+1."""
    total, n = 0.0, 0
    for qid, docs in run.items():
        rel = _relevant(qrels, qid)
        if not rel:
            continue
        n += 1
        rank = len(docs) + 1
        for r, d in enumerate(docs, start=1):
            if d in rel:
                rank = r
                break
        total += rank
    return total / max(n, 1)


def compute_metrics(run: Run, qrels: Qrels, names: List[str]) -> Dict[str, float]:
    out = {}
    for name in names:
        kind, k = parse_metric(name)
        if kind == "MRR":
            out[name] = mrr_at_k(run, qrels, k)
        elif kind == "Recall":
            out[name] = recall_at_k(run, qrels, k)
        elif kind == "nDCG":
            out[name] = ndcg_at_k(run, qrels, k)
        elif kind == "Success":
            out[name] = success_at_k(run, qrels, k)
        else:
            out[name] = average_rank(run, qrels)
    return out


def write_trec_run(path: str, run: Run, scores=None, tag: str = "asyncval"):
    """TREC 6-column run file (paper's --write_run)."""
    with open(path, "w") as f:
        for qid, docs in run.items():
            for rank, d in enumerate(docs, start=1):
                s = scores[qid][rank - 1] if scores else 1.0 / rank
                f.write(f"{qid} Q0 {d} {rank} {s:.6f} {tag}\n")


def read_trec_run(path: str) -> Dict[str, List[tuple]]:
    """Returns {qid: [(docid, score) ...]} sorted by score desc."""
    runs: Dict[str, list] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6:
                continue
            qid, _, did, _, score = parts[:5]
            runs.setdefault(qid, []).append((did, float(score)))
    return {q: sorted(v, key=lambda x: -x[1]) for q, v in runs.items()}


def read_trec_qrels(path: str) -> Qrels:
    qrels: Qrels = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            qid, _, did, gain = parts[:4]
            qrels.setdefault(qid, {})[did] = int(gain)
    return qrels
