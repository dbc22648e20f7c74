"""Cross-mode rerank parity of the port against the JAX package.

The cases of tests/test_rerank_parity.py: ragged, duplicate, unknown and
empty candidate lists, candidates confined to one chunk, shape extremes and
a seeded fuzz.  Every embedding is integer-valued (a pure-gather encoder
over a small-integer table, small-integer queries), so every dot product is
exact in f32 whatever the summation order, and the runs and scores must be
identical, not close:

  * the reference's dense ``rerank_run`` and its streaming
    ``StreamRerankStage``;
  * the port's ``rerank_run`` at the boundary query blocks (what the
    materialized engine runs), its streaming ``StreamRerankStage`` driven
    with chunk skipping, and the same stage with ``compact=True``;
  * whole pipelines: the port's streaming (compacted or not) and
    materialized engines, against the reference's materialized pipeline.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import retrieval as JR
from repro.core.pipeline import ValidationConfig as JaxConfig
from repro.core.pipeline import ValidationPipeline as JaxPipeline
from repro.core.samplers import SubsetResult as JaxSubset
from repro.models.biencoder import EncoderSpec as JaxSpec
from repro_torch.core import engine as E
from repro_torch.core import retrieval as R
from repro_torch.core.pipeline import ValidationConfig, ValidationPipeline
from repro_torch.core.samplers import SubsetResult
from repro_torch.models.biencoder import EncoderSpec
from tests.hypothesis_compat import given, settings, st

DIM = 8
VOCAB = 64


def _jax_gather(params, tokens, mask):
    del mask
    return jnp.take(params["table"], tokens[:, 0], axis=0)


def _torch_gather(params, tokens, mask):
    del mask
    return params["table"][tokens[:, 0].long()]


def _int_setup(n_docs, n_queries, seed):
    rng = np.random.default_rng(seed)
    table = rng.integers(-4, 5, size=(VOCAB, DIM)).astype(np.float32)
    doc_texts = [[int(i % VOCAB)] for i in range(n_docs)]
    c_emb = table[[t[0] for t in doc_texts]]
    q_emb = rng.integers(-4, 5, size=(n_queries, DIM)).astype(np.float32)
    return table, doc_texts, c_emb, q_emb


def _drive(stage, store, params, q_emb):
    """StreamingEngine's loop: the stage's own store when it compacted, and
    only the chunks it wants."""
    store = stage.store_override or store
    carry = stage.init(q_emb)
    for toks, mask, base, n_valid in store.chunks():
        if not stage.wants_chunk(base // store.chunk):
            continue
        carry = stage.step(params, q_emb, carry, toks, mask, base, n_valid)
    return stage.finalize(carry)


def _check_parity(n_docs, cand_lists, *, k, chunk, seed=0):
    Q = len(cand_lists)
    table, doc_texts, c_emb, q_emb = _int_setup(n_docs, Q, seed)
    qids = [f"q{i}" for i in range(Q)]
    dids = [f"d{i}" for i in range(n_docs)]
    per_query = {qid: list(c) for qid, c in zip(qids, cand_lists)}

    ref = JR.rerank_run(qids, jnp.asarray(q_emb), dids, jnp.asarray(c_emb),
                        per_query, k=k, q_block=max(Q, 1))
    jstore = JE.TokenStore.build(doc_texts, max_len=2, chunk=chunk)
    jstage = JE.StreamRerankStage(_jax_gather, k=k, query_ids=qids,
                                  doc_ids=dids, per_query=per_query,
                                  store=jstore, compact=False)
    carry = jstage.init(jnp.asarray(q_emb))
    for toks, mask, base, n_valid in jstore.chunks():
        if jstage.wants_chunk(base // jstore.chunk):
            carry = jstage.step({"table": jnp.asarray(table)},
                                jnp.asarray(q_emb), carry, toks, mask, base,
                                n_valid)
    assert jstage.finalize(carry) == ref

    q_t, c_t = torch.from_numpy(q_emb), torch.from_numpy(c_emb)
    for qb in (1, Q, Q + 1, None):
        assert R.rerank_run(qids, q_t, dids, c_t, per_query, k=k,
                            q_block=qb) == ref, f"q_block={qb}"
    store = E.TokenStore.build(doc_texts, max_len=2, chunk=chunk)
    params = {"table": torch.from_numpy(table)}
    for compact in (False, True):
        stage = E.StreamRerankStage(_torch_gather, k=k, query_ids=qids,
                                    doc_ids=dids, per_query=per_query,
                                    store=store, compact=compact)
        assert _drive(stage, store, params, q_t) == ref, \
            f"streaming (compact={compact}) diverged"
    return ref


def test_parity_ragged_duplicate_unknown_empty():
    run, scores = _check_parity(37, [
        ["d3", "d3", "d10", "d36"],
        [],
        [f"d{j}" for j in range(20)] + ["nope"],
        ["d36"],
        ["d0", "d5", "d5", "d7"],
    ], k=50, chunk=8)
    assert run["q1"] == [] and scores["q1"] == []
    assert len(run["q0"]) == 4 and len(run["q2"]) == 20


def test_parity_all_queries_empty():
    run, scores = _check_parity(12, [[], [], []], k=5, chunk=4)
    assert all(v == [] for v in run.values())
    assert all(v == [] for v in scores.values())


def test_parity_duplicate_tie_order_is_slot_stable():
    run, _ = _check_parity(10, [["d2", "d2", "d2"]], k=3, chunk=4)
    assert run["q0"] == ["d2", "d2", "d2"]


@pytest.mark.parametrize("n_docs,chunk,k", [
    (1, 1, 1), (9, 1, 3), (16, 16, 100), (23, 7, 2)])
def test_parity_shape_extremes(n_docs, chunk, k):
    rng = np.random.default_rng(n_docs)
    cand_lists = [[f"d{j}" for j in rng.integers(0, n_docs, size=m)]
                  for m in (1, 0, min(5, n_docs))]
    _check_parity(n_docs, cand_lists, k=k, chunk=chunk, seed=n_docs)


def test_parity_candidates_confined_to_one_chunk():
    _check_parity(40, [["d8", "d9", "d10"], ["d11", "d8"]], k=10, chunk=8)


def test_compaction_packs_sparse_candidates_and_skips_chunks():
    """One candidate in each of five chunks packs into one pseudo-chunk;
    confined candidates skip every other chunk; both keep the run."""
    table, doc_texts, _, q_emb = _int_setup(40, 2, 3)
    dids = [f"d{i}" for i in range(40)]
    pq = {"q0": ["d0", "d8", "d16"], "q1": ["d24", "d32", "d0"]}
    store = E.TokenStore.build(doc_texts, max_len=2, chunk=8)
    packed = E.StreamRerankStage(_torch_gather, k=10, query_ids=["q0", "q1"],
                                 doc_ids=dids, per_query=pq, store=store,
                                 compact=True)
    assert packed.store_override is not None
    assert packed.store_override.n_chunks == 1
    plain = E.StreamRerankStage(_torch_gather, k=10, query_ids=["q0", "q1"],
                                doc_ids=dids, per_query=pq, store=store)
    assert plain.store_override is None
    assert [plain.wants_chunk(ci) for ci in range(5)] == [True] * 5
    confined = E.StreamRerankStage(_torch_gather, k=10, query_ids=["q0"],
                                   doc_ids=dids, per_query={"q0": ["d9"]},
                                   store=store, compact=True)
    assert confined.store_override is None
    assert [confined.wants_chunk(ci) for ci in range(5)] == \
        [False, True, False, False, False]
    params, q = {"table": torch.from_numpy(table)}, torch.from_numpy(q_emb)
    assert _drive(packed, store, params, q) == _drive(plain, store, params,
                                                      q)


def _random_scenario(rng):
    n_docs = int(rng.integers(1, 41))
    chunk = int(rng.choice([1, 3, 8, 13]))
    cand_lists = []
    for _ in range(int(rng.integers(1, 5))):
        m = int(rng.integers(0, 9))
        cand_lists.append([f"d{int(j)}"
                           for j in rng.integers(0, n_docs + 3, size=m)])
    return n_docs, cand_lists, int(rng.integers(1, 61)), chunk


def test_parity_seeded_fuzz():
    rng = np.random.default_rng(7)
    for i in range(8):
        n_docs, cand_lists, k, chunk = _random_scenario(rng)
        _check_parity(n_docs, cand_lists, k=k, chunk=chunk, seed=i)


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_parity_property(seed):
    rng = np.random.default_rng(seed)
    n_docs, cand_lists, k, chunk = _random_scenario(rng)
    _check_parity(n_docs, cand_lists, k=k, chunk=chunk, seed=seed % 1000)


# ---------------------------------------------------------------------------
# Whole pipelines: the port's engines against the reference's
# ---------------------------------------------------------------------------


class _FixedSampler:
    """Pin per-query candidates so every pipeline scores the same subset."""

    name = "fixed"

    def __init__(self, per_query, subset_cls):
        self.per_query = per_query
        self.subset_cls = subset_cls

    def sample(self, corpus_ids, run, qrels):
        union = sorted({d for c in self.per_query.values() for d in c
                        if d in set(corpus_ids)})
        return self.subset_cls(doc_ids=union, per_query=self.per_query)


@pytest.mark.parametrize("mode", ["rerank", "average_rank"])
def test_pipeline_rerank_all_engines_identical(mode):
    n_docs, n_queries = 30, 4
    rng = np.random.default_rng(5)
    table, doc_texts, _, _ = _int_setup(n_docs, n_queries, seed=5)
    corpus = {f"d{i}": doc_texts[i] for i in range(n_docs)}
    queries = {f"q{i}": [int(rng.integers(0, VOCAB))]
               for i in range(n_queries)}
    qrels = {f"q{i}": {f"d{i}": 1} for i in range(n_queries)}
    per_query = {"q0": ["d1", "d1", "d4", "d29"], "q1": [],
                 "q2": [f"d{j}" for j in range(0, 24, 6)],
                 "q3": ["d29", "d0"]}
    jspec = JaxSpec(name="gather", dim=DIM, encode_query=_jax_gather,
                    encode_passage=_jax_gather, init=None, q_max_len=2,
                    p_max_len=2)
    ref_pipe = JaxPipeline(
        jspec, corpus, queries, qrels,
        JaxConfig(metrics=("MRR@10",), mode=mode, k=10, batch_size=8,
                  chunk_size=6, engine="materialized"),
        sampler=_FixedSampler(per_query, JaxSubset))
    jparams = {"table": jnp.asarray(table)}
    ref = ref_pipe.engine.run(jparams)[:2] + (
        ref_pipe.validate_params(jparams).metrics,)
    spec = EncoderSpec(name="gather", dim=DIM, encode_query=_torch_gather,
                       encode_passage=_torch_gather, init=None,
                       param_shapes={"table": (VOCAB, DIM)},
                       device=torch.device("cpu"), q_max_len=2, p_max_len=2)
    params = {"table": table}
    for name, kw in {"stream": dict(rerank_compact=False),
                     "stream_compact": dict(),
                     "mat_blocked": dict(engine="materialized",
                                         rerank_block=1),
                     "mat": dict(engine="materialized")}.items():
        p = ValidationPipeline(
            spec, corpus, queries, qrels,
            ValidationConfig(metrics=("MRR@10",), mode=mode, k=10,
                             batch_size=8, chunk_size=6, **kw),
            sampler=_FixedSampler(per_query, SubsetResult))
        run, scores, _ = p.engine.run(params)
        got = (run, scores, p.validate_params(params).metrics)
        assert got == ref, name
        assert ("AverageRank" in got[2]) == (mode == "average_rank")
