"""Corpus subset sampling strategies (the paper's §3 splitter + §2 variants).

Given a baseline run file (e.g. BM25 or a strong DR) and TREC qrels, keep
only the passages a validation query could plausibly retrieve — the paper
shows depth=100 cuts MS MARCO validation from ~2 h to ~10 min while
preserving the checkpoint-ranking trend (Figure 2).

Strategies:
  * FullCorpus        — no subsetting (the fidelity reference).
  * RunFileTopK       — paper's splitter: union over queries of the run's
                        top-``depth`` passages, plus all gold passages.
  * QrelPool          — DPR average-rank pool: golds + a small per-query pool.
  * RandomSubset      — control for the fidelity study.
  * RerankTopK        — RocketQA-style: per-query candidate lists (re-rank
                        validation instead of full retrieval).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.metrics import Qrels
from repro_torch.core.registry import register_sampler


@dataclasses.dataclass
class SubsetResult:
    """Either a global corpus subset or per-query candidates (rerank mode)."""
    doc_ids: List[str]
    per_query: Optional[Dict[str, List[str]]] = None

    @property
    def size(self) -> int:
        return len(self.doc_ids)


def _gold_ids(qrels: Qrels) -> set:
    out = set()
    for docs in qrels.values():
        out.update(d for d, g in docs.items() if g > 0)
    return out


class FullCorpus:
    name = "full"

    def sample(self, corpus_ids: Sequence[str], run=None, qrels=None
               ) -> SubsetResult:
        return SubsetResult(doc_ids=list(corpus_ids))


@dataclasses.dataclass
class RunFileTopK:
    """The paper's ``asyncval.splitter``: --run_file + --qrel_file + --depth."""
    depth: int

    @property
    def name(self):
        return f"run_top{self.depth}"

    def sample(self, corpus_ids: Sequence[str], run: Dict[str, List[tuple]],
               qrels: Qrels) -> SubsetResult:
        keep = _gold_ids(qrels)
        for qid, ranked in run.items():
            keep.update(d for d, _ in ranked[:self.depth])
        known = set(corpus_ids)
        return SubsetResult(doc_ids=sorted(keep & known))


@dataclasses.dataclass
class QrelPool:
    """DPR §2 average-rank pool: golds + per-query top-``pool`` candidates.
    Validation metric should be AverageRank over this pool."""
    pool: int = 30

    @property
    def name(self):
        return f"qrel_pool{self.pool}"

    def sample(self, corpus_ids: Sequence[str], run: Dict[str, List[tuple]],
               qrels: Qrels) -> SubsetResult:
        keep = _gold_ids(qrels)
        per_query: Dict[str, List[str]] = {}
        for qid, ranked in (run or {}).items():
            cands = [d for d, _ in ranked[:self.pool]]
            golds = [d for d, g in qrels.get(qid, {}).items() if g > 0]
            per_query[qid] = list(dict.fromkeys(golds + cands))
            keep.update(per_query[qid])
        known = set(corpus_ids)
        return SubsetResult(doc_ids=sorted(keep & known), per_query=per_query)


@dataclasses.dataclass
class RandomSubset:
    n: int
    seed: int = 0

    @property
    def name(self):
        return f"random{self.n}"

    def sample(self, corpus_ids: Sequence[str], run=None, qrels: Qrels = None
               ) -> SubsetResult:
        import random
        r = random.Random(self.seed)
        ids = list(corpus_ids)
        picked = set(r.sample(ids, min(self.n, len(ids))))
        if qrels:
            picked |= _gold_ids(qrels) & set(ids)
        return SubsetResult(doc_ids=sorted(picked))


@dataclasses.dataclass
class RerankTopK:
    """RocketQA-style re-rank validation: per-query top-``depth`` candidates
    (plus golds) — only these are encoded and scored for that query."""
    depth: int

    @property
    def name(self):
        return f"rerank_top{self.depth}"

    def sample(self, corpus_ids: Sequence[str], run: Dict[str, List[tuple]],
               qrels: Qrels) -> SubsetResult:
        known = set(corpus_ids)
        per_query: Dict[str, List[str]] = {}
        union = set()
        for qid, ranked in run.items():
            golds = [d for d, g in qrels.get(qid, {}).items() if g > 0]
            cands = [d for d, _ in ranked[:self.depth]]
            merged = [d for d in dict.fromkeys(golds + cands) if d in known]
            per_query[qid] = merged
            union.update(merged)
        return SubsetResult(doc_ids=sorted(union), per_query=per_query)


# ---------------------------------------------------------------------------
# Registry wiring: the sampler names the CLI / ValidationTask accept.  Each
# factory takes the subset ``depth`` (falling back to the strategy's
# historical default when 0) so `--sampler NAME --depth D` and
# `ValidationTask(sampler="NAME", sampler_depth=D)` both resolve here.
# Third-party samplers plug in with @register_sampler("name").
# ---------------------------------------------------------------------------


@register_sampler("full")
def _make_full(depth: int = 0) -> FullCorpus:
    return FullCorpus()


@register_sampler("run_topk")
def _make_run_topk(depth: int = 0) -> RunFileTopK:
    return RunFileTopK(depth=depth or 100)


@register_sampler("qrel_pool")
def _make_qrel_pool(depth: int = 0) -> QrelPool:
    return QrelPool(pool=depth or 30)


@register_sampler("random")
def _make_random(depth: int = 0) -> RandomSubset:
    return RandomSubset(n=depth or 100)


@register_sampler("rerank_topk")
def _make_rerank_topk(depth: int = 0) -> RerankTopK:
    return RerankTopK(depth=depth or 100)
