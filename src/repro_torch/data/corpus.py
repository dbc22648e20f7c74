"""The paper's corpus/query format + a synthetic retrieval dataset.

Asyncval §3: every line is ``{"text_id": str, "text": List[int]}`` — texts are
*pre-tokenized* (reason 1: custom tokenizers; reason 2: tokenize once, not per
checkpoint).  We keep that format exactly.

The synthetic dataset is a topic model; it draws from numpy's
``default_rng(seed)`` in the same order as the JAX package's
``repro.data.corpus``, so both packages build the same data from one seed.
The two baseline runs (a lexical "BM25" stand-in and a tunable-strength
oracle-plus-noise "strong DR") make the same draws too, so the subsets the
paper's fidelity study induces from them are the reference's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Tuple

import numpy as np

Tokens = List[int]


def write_jsonl(path: str, texts: Dict[str, Tokens]) -> None:
    with open(path, "w") as f:
        for tid, toks in texts.items():
            f.write(json.dumps({"text_id": str(tid),
                                "text": [int(t) for t in toks]}) + "\n")


def read_jsonl(path: str) -> Dict[str, Tokens]:
    out: Dict[str, Tokens] = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            obj = json.loads(line)
            out[str(obj["text_id"])] = list(obj["text"])
    return out


def pad_batch(token_lists: List[Tokens], max_len: int,
              pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """-> (tokens (B, max_len) int32, mask (B, max_len) bool)."""
    B = len(token_lists)
    toks = np.full((B, max_len), pad_id, np.int32)
    mask = np.zeros((B, max_len), bool)
    for i, t in enumerate(token_lists):
        t = t[:max_len]
        toks[i, :len(t)] = t
        mask[i, :len(t)] = True
    return toks, mask


@dataclasses.dataclass
class RetrievalDataset:
    corpus: Dict[str, Tokens]            # docid -> tokens
    queries: Dict[str, Tokens]           # qid -> tokens
    qrels: Dict[str, Dict[str, int]]     # qid -> {docid: gain}
    doc_topic: Dict[str, int]
    query_topic: Dict[str, int]
    vocab: int
    n_topics: int


def synthetic_retrieval_dataset(seed: int, *, n_passages: int = 2000,
                                n_queries: int = 100, vocab: int = 503,
                                n_topics: int = 25, p_len: int = 24,
                                q_len: int = 8, topic_frac_p: float = 0.5,
                                topic_frac_q: float = 0.7) -> RetrievalDataset:
    rng = np.random.default_rng(seed)
    # reserve 0=pad, 1=CLS; topic blocks partition part of the vocab
    common_lo, common_hi = 2, vocab // 3
    block = (vocab - common_hi) // n_topics
    assert block >= 2, "vocab too small for n_topics"

    def topic_tokens(t, n, frac):
        lo = common_hi + t * block
        choose_topic = rng.random(n) < frac
        toks = np.where(choose_topic,
                        rng.integers(lo, lo + block, n),
                        rng.integers(common_lo, common_hi, n))
        return toks.astype(np.int32).tolist()

    corpus, doc_topic = {}, {}
    for i in range(n_passages):
        t = int(rng.integers(n_topics))
        corpus[f"d{i}"] = [1] + topic_tokens(t, p_len - 1, topic_frac_p)
        doc_topic[f"d{i}"] = t

    # ensure every topic has at least a few docs
    queries, qrels, query_topic = {}, {}, {}
    by_topic: Dict[int, List[str]] = {}
    for d, t in doc_topic.items():
        by_topic.setdefault(t, []).append(d)
    topics_avail = [t for t, ds in by_topic.items() if ds]
    for i in range(n_queries):
        t = int(topics_avail[int(rng.integers(len(topics_avail)))])
        qid = f"q{i}"
        queries[qid] = [1] + topic_tokens(t, q_len - 1, topic_frac_q)
        gold = by_topic[t][int(rng.integers(len(by_topic[t])))]
        qrels[qid] = {gold: 1}
        query_topic[qid] = t
    return RetrievalDataset(corpus=corpus, queries=queries, qrels=qrels,
                            doc_topic=doc_topic, query_topic=query_topic,
                            vocab=vocab, n_topics=n_topics)


def lexical_baseline_run(ds: RetrievalDataset, k: int = 100, *,
                         drop_frac: float = 0.0,
                         seed: int = 0) -> Dict[str, List[tuple]]:
    """BM25 stand-in: idf-weighted token-overlap scores.

    ``drop_frac`` drops that fraction of each query's tokens before scoring —
    the vocabulary-mismatch failure mode that separates lexical retrievers
    from dense ones.  Dropped topical tokens make the run miss some
    same-topic documents entirely (exactly the hard negatives a trained DR
    confuses), so subsets induced from a dropped-token run track the
    full-corpus validation curve strictly *worse* than subsets from the
    topic-oracle run — the quality gap the paper's Figure-2 "stronger
    baselines track closer" claim needs.  ``drop_frac=0`` (default) is the
    original noiseless scorer."""
    rng = np.random.default_rng(seed)
    df = {}
    for toks in ds.corpus.values():
        for t in set(toks):
            df[t] = df.get(t, 0) + 1
    n_docs = len(ds.corpus)
    idf = {t: np.log(1 + n_docs / c) for t, c in df.items()}
    doc_sets = {d: set(toks) for d, toks in ds.corpus.items()}
    run = {}
    for qid, qtoks in ds.queries.items():
        qset = set(qtoks)
        if drop_frac > 0.0:
            qset = {t for t in qset if rng.random() >= drop_frac}
        scored = []
        for d, dset in doc_sets.items():
            overlap = qset & dset
            if overlap:
                scored.append((d, float(sum(idf.get(t, 0.0) for t in overlap))))
        scored.sort(key=lambda x: -x[1])
        run[qid] = scored[:k]
    return run


def oracle_noisy_baseline_run(ds: RetrievalDataset, noise: float, seed: int = 0,
                              k: int = 100, *,
                              overlap_weight: float = 0.0
                              ) -> Dict[str, List[tuple]]:
    """Tunable-strength DR baseline: topic-match oracle + Gaussian noise.
    noise≈0.3 behaves like a strong DR (TCT-ColBERTv2 stand-in); noise≈1.5
    approaches the lexical baseline's quality.

    ``overlap_weight`` > 0 adds an idf-weighted token-overlap term (scaled to
    [0, overlap_weight]) under the topic oracle, making the run *DR-like*
    rather than merely topic-aware: within (and across) topics it prefers
    the lexically-closest documents — the same documents a trained
    bag-of-embeddings DR scores highest.  Subsets induced from such a run
    contain the DR's actual hard negatives, which is what makes strong
    baselines track the full-corpus validation curve closer (paper Fig. 2);
    with the default 0.0 the within-topic order is pure noise and that
    claim degenerates to a coin flip on small corpora."""
    rng = np.random.default_rng(seed)
    docs = list(ds.corpus)
    doc_t = np.array([ds.doc_topic[d] for d in docs])
    overlap = np.zeros(len(docs))
    run = {}
    if overlap_weight > 0.0:
        df: Dict[int, int] = {}
        for toks in ds.corpus.values():
            for t in set(toks):
                df[t] = df.get(t, 0) + 1
        idf = {t: np.log(1 + len(docs) / c) for t, c in df.items()}
        doc_sets = [set(ds.corpus[d]) for d in docs]
    for qid in ds.queries:
        if overlap_weight > 0.0:
            qset = set(ds.queries[qid])
            raw = np.array([sum(idf.get(t, 0.0) for t in qset & dset)
                            for dset in doc_sets])
            overlap = overlap_weight * raw / max(raw.max(), 1e-9)
        base = (doc_t == ds.query_topic[qid]).astype(np.float64)
        scores = base + overlap + noise * rng.standard_normal(len(docs))
        order = np.argsort(-scores)[:k]
        run[qid] = [(docs[i], float(scores[i])) for i in order]
    return run
