"""The port's mmap-backed TokenStore against the JAX package's.

The same build sequences run in two cache directories, one per package,
and after every build both report the same reuse and rebuilt-chunk counts
and hold byte-identical files (``store_meta.json``, ``tokens.int32.bin``,
``mask.bool.bin``, ``chunk_hashes.json``).  Each package reads the other's
cache as a hit.  The fingerprint modes, the incremental rebuild and the
torn-cache repairs are the cases of tests/test_engine_staging.py and
tests/test_suite.py.  Memory-backed and mmap-backed streaming give
identical runs, and the suite shares and names its cache directories as
the reference's does.
"""

import os

import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro_torch.core import engine as E
from repro_torch.core.pipeline import ValidationConfig, ValidationPipeline
from repro_torch.core.suite import ValidationSuite, ValidationTask
from repro_torch.data import corpus as corpus_lib
from repro_torch.models.biencoder import EncoderSpec

FILES = ("store_meta.json", "tokens.int32.bin", "mask.bool.bin",
         "chunk_hashes.json")


def _texts(n, seed=0, length=6):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 50, size=length)))
            for _ in range(n)]


def _files(cache):
    out = {}
    for name in FILES:
        path = os.path.join(cache, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                out[name] = f.read()
    return out


def _mutate(texts, i, new):
    texts = [list(t) for t in texts]
    texts[i] = new
    return texts


def _torn_meta(cache):
    with open(os.path.join(cache, "store_meta.json"), "w") as f:
        f.write('{"version": 1, "n_te')


def _drop_tokens(cache):
    os.remove(os.path.join(cache, "tokens.int32.bin"))


T40 = _texts(40)
# each step: (texts, build kwargs, damage applied to the cache first)
_SCENARIOS = {
    "reuse_then_new_content": [
        (T40, {}, None), (T40, {}, None),
        ([[i + 7, i] for i in range(40)], {}, None)],
    "fast_middle_mutation_is_a_stale_hit": [
        (T40, {}, None), (_mutate(T40, 20, [999, 998]), {}, None)],
    "full_middle_mutation_rebuilds_one_chunk": [
        (T40, {"fingerprint": "full"}, None),
        (T40, {"fingerprint": "full"}, None),
        (_mutate(T40, 19, [44, 45, 46]), {"fingerprint": "full"}, None),
        (_mutate(T40, 19, [44, 45, 46]), {"fingerprint": "full"}, None)],
    "fast_rebuild_drops_the_manifest": [
        (T40, {"fingerprint": "full"}, None),
        (_mutate(T40, 0, [9, 9, 9]), {}, None)],
    "mode_switch_never_trusts_the_other_marker": [
        (T40, {"fingerprint": "full"}, None), (T40, {}, None),
        (T40, {"fingerprint": "full"}, None)],
    "geometry_change": [
        (T40, {"fingerprint": "full"}, None),
        (T40, {"fingerprint": "full", "chunk": 16}, None)],
    "torn_meta_and_missing_bin": [
        (T40, {}, None), (T40, {}, _torn_meta), (T40, {}, None),
        (T40, {}, _drop_tokens)],
    "ragged_tail": [(_texts(43, 1, 3), {"max_len": 5, "chunk": 16}, None)],
    "empty": [([], {}, None)],
}


# (scenario, step) whose build is the fast fingerprint's documented stale
# hit: the cache still holds the texts of the build before
_STALE = {("fast_middle_mutation_is_a_stale_hit", 1)}


@pytest.mark.parametrize("scenario", sorted(_SCENARIOS))
def test_mmap_store_matches_jax_byte_for_byte(tmp_path, scenario):
    caches = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    for step, (texts, kw, damage) in enumerate(_SCENARIOS[scenario]):
        kw = {"max_len": 8, "chunk": 8, **kw}
        if damage is not None:
            for cache in caches.values():
                damage(cache)
        ref = JE.TokenStore.build(texts, backing="mmap",
                                  cache_dir=caches["jax"], **kw)
        got = E.TokenStore.build(texts, backing="mmap",
                                 cache_dir=caches["port"], **kw)
        assert (got.reused, got.rebuilt_chunks, got.n_chunks) == \
            (ref.reused, ref.rebuilt_chunks, ref.n_chunks)
        assert _files(caches["port"]) == _files(caches["jax"])
        np.testing.assert_array_equal(np.asarray(got.tokens),
                                      np.asarray(ref.tokens))
        np.testing.assert_array_equal(np.asarray(got.mask),
                                      np.asarray(ref.mask))
        mem = E.TokenStore.build(texts, **kw)
        if (scenario, step) in _STALE:
            assert got.reused
            assert not np.array_equal(np.asarray(got.tokens), mem.tokens)
            continue
        np.testing.assert_array_equal(np.asarray(got.tokens), mem.tokens)
        np.testing.assert_array_equal(np.asarray(got.mask), mem.mask)


@pytest.mark.parametrize("fingerprint", ["fast", "full"])
def test_each_package_reads_the_others_cache(tmp_path, fingerprint):
    texts = _texts(30, seed=3)
    kw = dict(max_len=8, chunk=8, backing="mmap", fingerprint=fingerprint)
    port_dir, jax_dir = str(tmp_path / "p"), str(tmp_path / "j")
    built = E.TokenStore.build(texts, cache_dir=port_dir, **kw)
    read = JE.TokenStore.build(texts, cache_dir=port_dir, **kw)
    assert not built.reused and read.reused and read.rebuilt_chunks == 0
    np.testing.assert_array_equal(np.asarray(read.tokens),
                                  np.asarray(built.tokens))
    JE.TokenStore.build(texts, cache_dir=jax_dir, **kw)
    again = E.TokenStore.build(texts, cache_dir=jax_dir, **kw)
    assert again.reused and again.rebuilt_chunks == 0
    for (t, m, b, n), (jt, jm, jb, jn) in zip(
            again.chunks(), JE.TokenStore.build(texts, cache_dir=jax_dir,
                                                **kw).chunks()):
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        assert (b, n) == (jb, jn)


def test_mmap_store_is_read_only_and_checks_its_arguments(tmp_path):
    store = E.TokenStore.build([[1], [2]], max_len=3, chunk=2,
                               backing="mmap", cache_dir=str(tmp_path / "c"))
    assert isinstance(store.tokens, np.memmap)
    with pytest.raises(ValueError):
        store.tokens[0, 0, 0] = 99
    for kw in ({"backing": "mmap"}, {"backing": "bogus"},
               {"fingerprint": "bogus"}):
        with pytest.raises(ValueError):
            E.TokenStore.build([[1]], max_len=2, chunk=1, **kw)
    # staged chunks of a read-only map are plain writable tensors
    toks, mask = next(E.staged_batches(store, E.plan_schedule(1),
                                       device=torch.device("cpu")))
    assert toks.tolist() == [[1, 0, 0], [2, 0, 0]] and mask.dtype == \
        torch.bool


# ---------------------------------------------------------------------------
# Engines and the suite over an mmap store
# ---------------------------------------------------------------------------

VOCAB, DIM = 211, 16


def _toy(params, tokens, mask):
    emb = params["table"][tokens]
    m = mask.to(emb.dtype)[..., None]
    v = (emb * m).sum(1) / torch.clamp(m.sum(1), min=1e-6)
    return v / torch.clamp(v.norm(dim=-1, keepdim=True), min=1e-6)


def _spec():
    return EncoderSpec(name="toy", dim=DIM, encode_query=_toy,
                       encode_passage=_toy, init=None,
                       param_shapes={"table": (VOCAB, DIM)},
                       device=torch.device("cpu"), q_max_len=8,
                       p_max_len=20)


@pytest.fixture(scope="module")
def ds():
    return corpus_lib.synthetic_retrieval_dataset(2, n_passages=200,
                                                  n_queries=12, vocab=VOCAB)


@pytest.mark.parametrize("impl,chunk", [("torch", 64), ("cuda", 48)])
def test_memory_and_mmap_streaming_identical(tmp_path, ds, impl, chunk):
    params = {"table": np.random.default_rng(4).normal(
        size=(VOCAB, DIM)).astype(np.float32)}
    outs = []
    for kw in (dict(staging="sync"),
               dict(token_backing="mmap", mmap_dir=str(tmp_path / "tc"),
                    token_fingerprint="full")):
        p = ValidationPipeline(_spec(), ds.corpus, ds.queries, ds.qrels,
                               ValidationConfig(impl=impl, chunk_size=chunk,
                                                k=20, **kw))
        run, scores, _ = p.engine.run(params)
        outs.append((run, scores, p.validate_params(params).metrics))
    assert outs[0] == outs[1]
    assert p.engine.doc_store.backing == "mmap"
    assert os.listdir(str(tmp_path / "tc")) == ["corpus_tokens"]


def test_suite_shares_and_names_mmap_caches(tmp_path, ds):
    other = corpus_lib.synthetic_retrieval_dataset(3, n_passages=50,
                                                   n_queries=4, vocab=VOCAB)
    mmap_dir = str(tmp_path / "mm")
    vcfg = ValidationConfig(k=10, chunk_size=32, token_backing="mmap",
                            mmap_dir=mmap_dir)
    tasks = [ValidationTask("a", ds.corpus, ds.queries, ds.qrels),
             ValidationTask("b", ds.corpus, ds.queries, ds.qrels,
                            metrics=("Recall@10",)),
             ValidationTask("c", other.corpus, other.queries, other.qrels)]
    suite = ValidationSuite(_spec(), tasks, vcfg)
    suite.engine("c")                     # built first, still index 1
    suite.build_engines()
    assert suite.store_builds == 2
    assert sorted(os.listdir(mmap_dir)) == ["corpus_tokens",
                                            "corpus_tokens_1"]
    assert suite.engine("a").doc_store is suite.engine("b").doc_store
    assert E.doc_cache_dir(None) is None
    assert E.doc_cache_dir("x", 2) == os.path.join("x", "corpus_tokens_2")
    # a second suite over the same corpora reuses both caches
    again = ValidationSuite(_spec(), tasks, vcfg)
    again.build_engines()
    assert all(again.engine(n).doc_store.reused for n in "abc")
    with pytest.raises(ValueError, match="mmap_dir"):
        ValidationPipeline(_spec(), ds.corpus, ds.queries, ds.qrels,
                           ValidationConfig(token_backing="mmap"))
