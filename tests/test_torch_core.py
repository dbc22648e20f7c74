"""The port's core modules against the JAX package's, module by module.

Data, metrics, precision, token stores and the streaming engine get the same
inputs on both sides; the validator pieces (ledger, watcher, retries) are
checked for the reference's behaviour.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import metrics as jmetrics
from repro.core import precision as jprecision
from repro.data import corpus as jcorpus
from repro.models.biencoder import EncoderSpec as JaxSpec
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import engine, metrics, precision, registry
from repro_torch.core.suite import (ValidationConfig, ValidationSuite,
                                    ValidationTask)
from repro_torch.core.validator import AsyncValidator, ValidationLedger
from repro_torch.core.watcher import CheckpointWatcher, Policy
from repro_torch.data import corpus
from repro_torch.models.biencoder import EncoderSpec

VOCAB, DIM = 211, 16


def _jax_toy(params, tokens, mask):
    emb = jnp.take(params["table"], tokens, axis=0)
    m = mask.astype(emb.dtype)[..., None]
    v = (emb * m).sum(1) / jnp.clip(m.sum(1), 1e-6)
    return v / jnp.clip(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-6)


def _torch_toy(params, tokens, mask):
    emb = params["table"][tokens]
    m = mask.to(emb.dtype)[..., None]
    v = (emb * m).sum(1) / torch.clamp(m.sum(1), min=1e-6)
    return v / torch.clamp(v.norm(dim=-1, keepdim=True), min=1e-6)


def _torch_spec():
    return EncoderSpec(name="toy", dim=DIM, encode_query=_torch_toy,
                       encode_passage=_torch_toy, init=None,
                       param_shapes={"table": (VOCAB, DIM)},
                       device=torch.device("cpu"), q_max_len=8,
                       p_max_len=20)


def _dataset():
    return corpus.synthetic_retrieval_dataset(1, n_passages=150,
                                              n_queries=10, vocab=VOCAB)


def test_synthetic_dataset_matches_jax():
    mine = corpus.synthetic_retrieval_dataset(5, n_passages=80, n_queries=9)
    ref = jcorpus.synthetic_retrieval_dataset(5, n_passages=80, n_queries=9)
    assert mine.corpus == ref.corpus and mine.queries == ref.queries
    assert mine.qrels == ref.qrels and mine.doc_topic == ref.doc_topic


def test_jsonl_and_pad_batch_match_jax(tmp_path):
    ds = _dataset()
    corpus.write_jsonl(str(tmp_path / "a.jsonl"), ds.queries)
    jcorpus.write_jsonl(str(tmp_path / "b.jsonl"), ds.queries)
    assert (tmp_path / "a.jsonl").read_bytes() == \
        (tmp_path / "b.jsonl").read_bytes()
    assert corpus.read_jsonl(str(tmp_path / "a.jsonl")) == ds.queries
    texts = list(ds.corpus.values())[:7]
    for a, b in zip(corpus.pad_batch(texts, 12),
                    jcorpus.pad_batch(texts, 12)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("names", [["MRR@10", "Recall@5", "nDCG@10",
                                    "Success@3", "AverageRank"]])
def test_metrics_match_jax(names):
    rng = np.random.default_rng(0)
    docs = [f"d{i}" for i in range(30)]
    run = {f"q{i}": list(rng.permutation(docs)[:12]) for i in range(8)}
    qrels = {f"q{i}": {docs[int(rng.integers(30))]: 1} for i in range(8)}
    assert metrics.compute_metrics(run, qrels, names) == \
        jmetrics.compute_metrics(run, qrels, names)


@pytest.mark.parametrize("score_dtype", ["f32", "bf16", "int8"])
def test_chunk_scores_match_jax(score_dtype):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(6, 40)).astype(np.float32)
    c = rng.normal(size=(30, 40)).astype(np.float32)
    want = np.asarray(jprecision.chunk_scores(jnp.asarray(q), jnp.asarray(c),
                                              score_dtype))
    got = precision.chunk_scores(torch.from_numpy(q), torch.from_numpy(c),
                                 score_dtype).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    a, b = precision.quantize_rows_np(c), jprecision.quantize_rows_np(c)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_token_store_and_schedule_match_jax():
    texts = list(_dataset().corpus.values())
    mine = engine.TokenStore.build(texts, max_len=20, chunk=32)
    ref = jengine.TokenStore.build(texts, max_len=20, chunk=32)
    np.testing.assert_array_equal(mine.tokens, ref.tokens)
    np.testing.assert_array_equal(mine.mask, ref.mask)
    assert [mine.rows_valid(i) for i in range(mine.n_chunks)] == \
        [ref.rows_valid(i) for i in range(ref.n_chunks)]
    for n in (13, 5, 0):
        assert engine.plan_schedule(n) == jengine.plan_schedule(n, 1)
        for w in (1, 2, 3, 4, 8, 16):
            assert engine.plan_schedule(n, w) == jengine.plan_schedule(n, w)
    staged = list(engine.staged_batches(
        mine, engine.plan_schedule(mine.n_chunks),
        device=torch.device("cpu"), depth=3))
    assert len(staged) == mine.n_chunks
    np.testing.assert_array_equal(staged[-1][0].numpy(), mine.tokens[-1])
    # the reference's error: an mmap store needs its cache directory
    with pytest.raises(ValueError, match="cache_dir"):
        engine.TokenStore.build(texts, max_len=20, chunk=32, backing="mmap")


@pytest.mark.parametrize("impl,score_dtype", [("torch", "f32"),
                                              ("cuda", "f32"),
                                              ("torch", "int8"),
                                              ("cuda", "bf16")])
def test_streaming_engine_matches_jax(impl, score_dtype):
    ds = _dataset()
    table = np.random.default_rng(3).normal(size=(VOCAB, DIM)) \
        .astype(np.float32)
    qids, dids = list(ds.queries), list(ds.corpus)
    mine = engine.make_engine(
        _torch_spec(),
        engine.ValidationStore(qids, [ds.queries[q] for q in qids], dids,
                               [ds.corpus[d] for d in dids]),
        ValidationConfig(k=15, chunk_size=40, impl=impl,
                         score_dtype=score_dtype, staging_depth=3))
    jspec = JaxSpec(name="toy", dim=DIM, encode_query=_jax_toy,
                    encode_passage=_jax_toy, init=None, q_max_len=8,
                    p_max_len=20)
    from repro.core.suite import ValidationConfig as JaxConfig
    ref = jengine.make_engine(
        jspec, jengine.ValidationStore(qids, [ds.queries[q] for q in qids],
                                       dids, [ds.corpus[d] for d in dids]),
        JaxConfig(k=15, chunk_size=40, score_dtype=score_dtype))
    run, scores, timings = mine.run({"table": table})
    jrun, jscores, _ = ref.run({"table": jnp.asarray(table)})
    assert set(timings) == {"encode_corpus_s", "encode_query_s",
                            "retrieve_s", "total_s"}
    assert mine.name == "streaming" and mine.score_dtype == score_dtype
    for q in qids:
        np.testing.assert_allclose(scores[q], jscores[q], rtol=1e-5,
                                   atol=1e-5)
        assert set(run[q]) == set(jrun[q])


def test_registries_are_the_ports_own():
    registry.ensure_builtins()
    assert registry.IMPLS.names() == ["cuda", "torch"]
    assert registry.ENGINES.names() == ["materialized", "streaming"]
    with pytest.raises(ValueError, match="did you mean 'torch'"):
        registry.IMPLS.get("torc")
    from repro.core import registry as jregistry
    assert jregistry.IMPLS is not registry.IMPLS


def test_ledger_rows_reload_and_torn_tail(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    suite = ValidationSuite(_torch_spec(), [ValidationTask(
        "default", _dataset().corpus, _dataset().queries, _dataset().qrels)],
        ValidationConfig(k=10, chunk_size=64))
    table = np.random.default_rng(4).normal(size=(VOCAB, DIM)) \
        .astype(np.float32)
    ledger = ValidationLedger(path, expected_tasks=suite.task_names)
    ledger.record(suite.validate_params({"table": table}, step=3))
    with open(path, "a") as f:
        f.write('{"step": 9, "ta')                # crash mid-append
    again = ValidationLedger(path, expected_tasks=("default",))
    assert again.validated_steps == [3] and 3 in again
    row = again.rows()[0]
    assert set(row) == {"step", "task", "metrics", "timings", "subset_size",
                        "engine", "score_dtype"}
    assert row["subset_size"] == 150 and row["engine"] == "streaming"
    ValidationLedger(path).record(suite.validate_params({"table": table},
                                                        step=4))
    with open(path) as f:
        assert [json.loads(line)["step"] for line in f] == [3, 4]


@pytest.mark.parametrize("kind,want", [("fifo", [2, 4, 6]),
                                       ("latest_first", [6]),
                                       ("stride", [4])])
def test_watcher_policies(tmp_path, kind, want):
    for step in (2, 4, 6):
        ckpt.save(str(tmp_path), step, {"x": np.zeros(2)})
    os.makedirs(tmp_path / "step_0000000008.tmp")       # never visible
    w = CheckpointWatcher(str(tmp_path), policy=Policy(kind, stride=4))
    assert w.poll() == want
    assert w.poll() == []
    assert w.skipped == {2, 4, 6} - set(want)


def test_validator_retries_then_gives_up(tmp_path):
    ds = _dataset()
    suite = ValidationSuite(_torch_spec(), [ValidationTask(
        "default", ds.corpus, ds.queries, ds.qrels)],
        ValidationConfig(k=10, chunk_size=64))
    table = np.random.default_rng(5).normal(size=(VOCAB, DIM)) \
        .astype(np.float32)
    ckpt.save(str(tmp_path / "ck"), 1, {"params": {"table": table}})
    ckpt.save(str(tmp_path / "ck"), 2, {"params": {"table": table[:5]}})
    v = AsyncValidator(str(tmp_path / "ck"), suite, max_retries=1,
                       ledger_path=str(tmp_path / "ledger.jsonl"))
    v.validate_all_existing()
    assert [r.step for r in v.results] == [1]
    assert [s for s, _ in v.errors] == [2]      # bad shape: recorded, retried
    v.validate_pending()
    v.validate_pending()
    assert [s for s, _ in v.errors] == [2, 2]
    assert v.protect_set() == {2}


def test_validator_thread_validates_while_checkpoints_land(tmp_path):
    """The paper's async mode: the validator runs on its own thread while
    checkpoints are committed; stop(drain=True) validates the rest."""
    ds = _dataset()
    suite = ValidationSuite(_torch_spec(), [ValidationTask(
        "default", ds.corpus, ds.queries, ds.qrels)],
        ValidationConfig(k=10, chunk_size=64))
    rng = np.random.default_rng(6)
    root = str(tmp_path / "ck")
    v = AsyncValidator(root, suite, poll_interval_s=0.01)
    v.start()
    for step in (1, 2, 3):
        table = rng.normal(size=(VOCAB, DIM)).astype(np.float32)
        ckpt.save(root, step, {"params": {"table": table}})
    v.stop(drain=True, drain_timeout=60)
    assert sorted(r.step for r in v.results) == [1, 2, 3]
    assert not v.errors and v.protect_set() == set()


def test_encode_texts_matches_jax():
    from repro.core.encoder import encode_texts as jax_encode_texts
    from repro_torch.core.encoder import encode_texts
    texts = list(_dataset().corpus.values())[:37]
    table = np.random.default_rng(7).normal(size=(VOCAB, DIM)) \
        .astype(np.float32)
    got, stats = encode_texts(_torch_toy, {"table": torch.from_numpy(table)},
                              texts, max_len=20, batch_size=16,
                              device="cpu")
    want, _ = jax_encode_texts(_jax_toy, {"table": jnp.asarray(table)},
                               texts, max_len=20, batch_size=16)
    assert got.shape == (37, DIM) and stats.n_batches == 3
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
