"""The one traffic generator: every mix under ``bench/traffic/`` is a JSON
file of parameters that this module turns into inputs from ``--seed``.

Every seed gets the same multiset of sizes (token counts, gaps between
arrivals, relevant passages per query) and a different order and
different token ids: the sizes are quantiles of the mix's distribution,
shuffled by the seed.  So two seeds do the same amount of work, and a
spread between seeds is the system's, not the generator's.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import numpy as np

_U64 = (1 << 64) - 1


def rng(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator for ``seed`` (any whole number) and a stream tag."""
    return np.random.default_rng([int(seed) & _U64, int(seed) < 0, *tags])


def torch_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for a ``torch.Generator``, derived from ``seed``."""
    state = np.random.SeedSequence([int(seed) & _U64, int(seed) < 0, *tags])
    return int(state.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the mid-quantiles of a log-normal with the given
    ``median`` and ``sigma``, rounded and clipped to ``[min, max]``:
    heavy-tailed, and the same multiset for every seed."""
    if spec.get("dist", "lognormal") != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    nd = statistics.NormalDist()
    mu, sigma = math.log(spec["median"]), spec["sigma"]
    out = [round(math.exp(mu + sigma * nd.inv_cdf((i + 0.5) / n)))
           for i in range(n)]
    return np.clip(np.array(out, np.int64), spec["min"], spec["max"])


def token_lists(g: np.random.Generator, lengths: Sequence[int],
                vocab: int) -> List[List[int]]:
    """Token ids drawn uniformly over the whole vocabulary."""
    flat = g.integers(0, vocab, size=int(np.sum(lengths)), dtype=np.int64)
    out, at = [], 0
    for n in lengths:
        out.append(flat[at:at + int(n)].tolist())
        at += int(n)
    return out


def validation_set(mix: dict, seed: int, vocab: int) -> dict:
    """An MS MARCO-shaped validation set: queries, a baseline run of
    ``depth`` distinct candidates per query (the union is the corpus),
    and qrels whose relevant passages lie among each query's candidates.

    Returns ``{"queries": {qid: tokens}, "corpus": {pid: tokens}, "run":
    {qid: [(pid, score), ...]}, "qrels": {qid: {pid: 1}}}``, each dict in
    generation order."""
    g = rng(seed, 1)
    nq, depth = mix["n_queries"], mix["depth"]
    n_docs = nq * depth
    q_len = g.permutation(quantile_lengths(mix["query_tokens"], nq))
    p_len = g.permutation(quantile_lengths(mix["passage_tokens"], n_docs))
    # MS MARCO-like passage ids: distinct 7-digit numbers in random order
    pids = [f"{p}" for p in g.choice(9_000_000, n_docs, replace=False)
            + 1_000_000]
    qids = [f"{q}" for q in g.choice(900_000, nq, replace=False) + 100_000]
    queries = dict(zip(qids, token_lists(g, q_len, vocab)))
    corpus = dict(zip(pids, token_lists(g, p_len, vocab)))
    n_rel = []
    for count, n_queries in sorted(mix["relevant_per_query"].items()):
        n_rel += [int(count)] * int(n_queries)
    if len(n_rel) != nq:
        raise ValueError("relevant_per_query must cover every query")
    n_rel = g.permutation(n_rel)
    run, qrels = {}, {}
    for qi, qid in enumerate(qids):
        cands = pids[qi * depth:(qi + 1) * depth]
        run[qid] = [(p, float(depth - r)) for r, p in enumerate(cands)]
        rel = g.choice(depth, int(n_rel[qi]), replace=False)
        qrels[qid] = {cands[int(r)]: 1 for r in rel}
    return {"queries": queries, "corpus": corpus, "run": run, "qrels": qrels}


def query_stream(mix: dict, seed: int, vocab: int, seconds: float,
                 rate: float) -> Dict[str, list]:
    """An open-loop stream at ``rate`` queries a second over ``seconds``:
    ``round(rate * seconds)`` arrivals whose gaps are the exponential
    distribution's mid-quantiles (a Poisson stream), scaled so the stream
    fills the window.

    The schedule is the mix's own: its order comes from
    ``mix["arrival_seed"]``, so every seed replays the same arrivals, as a
    recorded trace would, and the seed decides which query arrives when
    (their token ids, and the order of their lengths).  The device's work
    per batch is the same for every seed, so the 95th percentile would
    otherwise measure the bursts of one seed's schedule.

    Returns ``{"due": [s from the window's start], "qids": [...],
    "tokens": [[...], ...]}``."""
    n = max(1, int(round(rate * seconds)))
    gaps = rng(mix["arrival_seed"], 2).permutation(
        [-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    if n > 1:
        due = due * (seconds * (n - 1) / n) / float(due[-1])
    g = rng(seed, 2)
    lengths = g.permutation(quantile_lengths(mix["query_tokens"], n))
    return {"due": [float(t) for t in due],
            "qids": [f"q{i}" for i in range(n)],
            "tokens": token_lists(g, lengths, vocab)}
