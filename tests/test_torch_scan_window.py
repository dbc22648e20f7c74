"""``--scan_window`` in the port: the reference's windowed dispatch.

``plan_schedule`` must give the reference's schedule (the halving tail)
for every corpus size and window.  The ``torch`` stage folds a window's
chunks one at a time in chunk order, so runs (``.trec`` bytes) and ledger
rows (all but ``timings``) are bit-equal at windows 1, 2, 8 and one larger
than the corpus, on memory and mmap token stores; at every window the
port's rows hold against the reference's at the same window with the
port's parity gates (f32: allclose and equal top-k sets; int8: exact).
The ``cuda`` and mesh stages take one chunk per step, as the reference
builds its Pallas and ``shard_map`` stages.
"""

import json

import numpy as np
import pytest
import torch

from benchmarks.common import toy_spec as jtoy_spec
from repro.core import engine as JE
from repro.core.suite import ValidationConfig as JConfig
from repro.core.suite import ValidationSuite as JSuite
from repro.core.suite import ValidationTask as JTask
from repro_torch.core import engine as E
from repro_torch.core.suite import (ValidationConfig, ValidationSuite,
                                    ValidationTask)
from repro_torch.core.validator import ValidationLedger
from repro_torch.data import corpus as corpus_lib
from repro_torch.distributed import compat
from repro_torch.models.toy import toy_spec

VOCAB = 211
CHUNK = 16
METRICS = ("MRR@10", "Recall@20", "nDCG@10")


@pytest.fixture(scope="module")
def ds():
    # 200 passages in chunks of 16: 13 chunks, the last one part-filled
    return corpus_lib.synthetic_retrieval_dataset(5, n_passages=200,
                                                  n_queries=12, vocab=VOCAB)


@pytest.fixture(scope="module")
def params():
    return {"table": (0.1 * np.random.default_rng(7).standard_normal(
        (VOCAB, 32))).astype(np.float32)}


@pytest.mark.parametrize("window", [1, 2, 3, 8, 64])
def test_plan_schedule_matches_reference(window):
    for n in range(41):
        got = E.plan_schedule(n, window)
        assert got == JE.plan_schedule(n, window), (n, window)
        # every chunk once, in order
        assert [c for ci, w in got for c in range(ci, ci + w)] == \
            list(range(n))
    assert E.plan_schedule(13) == [(ci, 1) for ci in range(13)]


def test_halving_tail():
    assert E.plan_schedule(13, 8) == [(0, 8), (8, 4), (12, 1)]
    assert E.plan_schedule(8, 3) == [(0, 3), (3, 3), (6, 1), (7, 1)]
    assert E.plan_schedule(5, 64) == [(0, 4), (4, 1)]


@pytest.mark.parametrize("backing", ["memory", "mmap"])
def test_staged_windows_are_the_store_chunks(tmp_path, ds, backing):
    texts = list(ds.corpus.values())
    store = E.TokenStore.build(texts, max_len=20, chunk=CHUNK,
                               backing=backing,
                               cache_dir=str(tmp_path / "tc")
                               if backing == "mmap" else None)
    schedule = E.plan_schedule(store.n_chunks, 8)
    staged = list(E.staged_batches(store, schedule,
                                   device=torch.device("cpu"), depth=2))
    assert len(staged) == len(schedule) == 3
    for (ci, w), (toks, mask) in zip(schedule, staged):
        want = (w, CHUNK, 20) if w > 1 else (CHUNK, 20)
        assert tuple(toks.shape) == tuple(mask.shape) == want
        np.testing.assert_array_equal(
            toks.numpy().reshape(-1, 20),
            np.asarray(store.tokens[ci:ci + w]).reshape(-1, 20))
        np.testing.assert_array_equal(
            mask.numpy().reshape(-1, 20),
            np.asarray(store.mask[ci:ci + w]).reshape(-1, 20))


def _port_rows(ds, params, tmp_path, *, window, backing, score_dtype="f32",
               impl="torch"):
    out = tmp_path / f"{impl}_{backing}_{score_dtype}_w{window}"
    vcfg = ValidationConfig(metrics=METRICS, k=20, impl=impl,
                            chunk_size=CHUNK, scan_window=window,
                            token_backing=backing,
                            mmap_dir=str(tmp_path / "tc")
                            if backing == "mmap" else None,
                            score_dtype=score_dtype, write_run=True,
                            output_dir=str(out))
    suite = ValidationSuite(toy_spec(VOCAB, device="cpu"), [
        ValidationTask("default", ds.corpus, ds.queries, ds.qrels)], vcfg)
    ledger = ValidationLedger(str(out / "ledger.jsonl"))
    for step in (10, 20):
        scaled = {"table": params["table"] * (1.0 + step / 100)}
        ledger.record(suite.validate_params(scaled, step))
    rows = [json.loads(line) for line in open(out / "ledger.jsonl")]
    runs = {step: open(out / f"asyncval_step{step}.trec", "rb").read()
            for step in (10, 20)}
    return rows, runs, suite


@pytest.mark.parametrize("score_dtype", ["f32", "int8"])
@pytest.mark.parametrize("backing", ["memory", "mmap"])
def test_rows_and_runs_bit_equal_across_windows(tmp_path, ds, params,
                                                backing, score_dtype):
    n_chunks = -(-len(ds.corpus) // CHUNK)
    base_rows, base_runs, suite = _port_rows(
        ds, params, tmp_path, window=1, backing=backing,
        score_dtype=score_dtype)
    assert suite.engine("default").stage.window == 1
    for window in (2, 8, n_chunks + 3):
        rows, runs, suite = _port_rows(ds, params, tmp_path, window=window,
                                       backing=backing,
                                       score_dtype=score_dtype)
        assert suite.engine("default").stage.window == window
        assert runs == base_runs, window
        for got, want in zip(rows, base_rows):
            assert set(got["timings"]) == set(want["timings"])
            assert {k: v for k, v in got.items() if k != "timings"} == \
                {k: v for k, v in want.items() if k != "timings"}, window
        assert len(rows) == len(base_rows) == 2


def _engine_spy(engine, calls):
    """Record the engine's dispatches (not the steps a window folds)."""
    stage, inside = engine.stage, []
    for name in ("step", "step_window"):
        real = getattr(stage, name, None)
        if real is None:
            continue

        def spy(*a, _real=real, _name=name):
            if not inside:
                calls.append(_name)
            inside.append(_name)
            try:
                return _real(*a)
            finally:
                inside.pop()
        setattr(stage, name, spy)


@pytest.mark.parametrize("window", [1, 3, 8])
def test_engine_dispatches_the_schedule(ds, params, window):
    """One ``step_window`` per multi-chunk entry, one ``step`` per
    single-chunk entry; each window folds its chunks through ``step``."""
    vcfg = ValidationConfig(k=20, chunk_size=CHUNK, scan_window=window)
    suite = ValidationSuite(toy_spec(VOCAB, device="cpu"), [
        ValidationTask("default", ds.corpus, ds.queries, ds.qrels)], vcfg)
    engine = suite.engine("default")
    real_step, calls, folded = engine.stage.step, [], []

    def step(*a):
        folded.append(a[5])                 # base
        return real_step(*a)
    engine.stage.step = step
    _engine_spy(engine, calls)
    engine.run(params)
    schedule = E.plan_schedule(engine.doc_store.n_chunks, window)
    assert calls == ["step_window" if w > 1 else "step"
                     for _, w in schedule]
    assert folded == [CHUNK * ci for ci in range(engine.doc_store.n_chunks)]


def _ref_run(ds, params, *, window, score_dtype):
    vcfg = JConfig(metrics=METRICS, k=20, impl="xla", chunk_size=CHUNK,
                   scan_window=window, score_dtype=score_dtype)
    suite = JSuite(jtoy_spec(VOCAB), [
        JTask("default", ds.corpus, ds.queries, ds.qrels)], vcfg)
    run, scores, _ = suite.engine("default").run(params)
    return run, scores, suite.validate_params(params, 0).tasks[
        "default"].metrics


@pytest.mark.parametrize("window", [1, 2, 8, 16])
@pytest.mark.parametrize("score_dtype", ["f32", "int8"])
def test_windowed_rows_match_reference(ds, params, window, score_dtype):
    """At the same window the port's run and metrics against the
    reference's: allclose and equal top-k sets at f32, exact at int8."""
    vcfg = ValidationConfig(metrics=METRICS, k=20, impl="torch",
                            chunk_size=CHUNK, scan_window=window,
                            score_dtype=score_dtype)
    suite = ValidationSuite(toy_spec(VOCAB, device="cpu"), [
        ValidationTask("default", ds.corpus, ds.queries, ds.qrels)], vcfg)
    run, scores, _ = suite.engine("default").run(params)
    metrics = suite.validate_params(params, 0).tasks["default"].metrics
    jrun, jscores, jmetrics = _ref_run(ds, params, window=window,
                                       score_dtype=score_dtype)
    assert set(run) == set(jrun)
    for qid in jrun:
        if score_dtype == "int8":
            assert run[qid] == jrun[qid]
            np.testing.assert_allclose(scores[qid], jscores[qid],
                                       rtol=1e-6, atol=0)
        else:
            assert set(run[qid]) == set(jrun[qid])
            np.testing.assert_allclose(scores[qid], jscores[qid],
                                       rtol=1e-5, atol=1e-6)
    for name, v in jmetrics.items():
        assert metrics[name] == pytest.approx(v, abs=1e-6), name


def _toy_enc(params, tokens, mask):
    return toy_spec(VOCAB, device="cpu").encode_passage(params, tokens,
                                                        mask)


def test_cuda_and_mesh_stages_take_one_chunk():
    kw = dict(k=5, query_ids=["q"], doc_ids=[f"d{i}" for i in range(40)],
              scan_window=8)
    torch_stage = E.make_stage(_toy_enc, mode="retrieval", impl="torch",
                               **kw)
    assert (torch_stage.name, torch_stage.window) == ("topk_torch", 8)
    cuda_stage = E.make_stage(_toy_enc, mode="retrieval", impl="cuda", **kw)
    assert (cuda_stage.name, cuda_stage.window) == ("topk_cuda", 1)
    mesh = compat.make_mesh((2, 2), ("data", "model"),
                            devices=[torch.device("cpu")] * 4)
    sharded = E.make_stage(_toy_enc, mode="retrieval", impl="torch",
                           mesh=mesh, **kw)
    assert (sharded.name, sharded.window) == ("topk_sharded", 1)
    on_mesh_cuda = E.make_stage(_toy_enc, mode="retrieval", impl="cuda",
                                mesh=mesh, **kw)
    assert on_mesh_cuda.window == 1
    rerank = E.make_stage(_toy_enc, mode="rerank", impl="torch",
                          per_query={"q": ["d1", "d2"]}, **kw)
    assert not hasattr(rerank, "step_window")
    assert getattr(rerank, "window", 1) == 1
    # a sharded stage is never handed a window
    store = E.TokenStore.build([[1, 2]] * 40, max_len=4, chunk=8)
    with pytest.raises(ValueError, match="one chunk per step"):
        next(E.staged_batches(store, [(0, 2)], device=torch.device("cpu"),
                              sharding=sharded.input_sharding))


@pytest.mark.parametrize("impl,mesh", [("cuda", False), ("torch", True)])
def test_cuda_and_mesh_engines_step_per_chunk(ds, params, impl, mesh):
    """Under ``impl="cuda"`` and on a mesh the engine takes one chunk per
    step at the default window, and the run equals the window-1 torch
    run."""
    vcfg = ValidationConfig(k=20, impl=impl, chunk_size=CHUNK,
                            mesh=compat.make_mesh(
                                (2, 2), ("data", "model"),
                                devices=[torch.device("cpu")] * 4)
                            if mesh else None)
    assert vcfg.scan_window == 8
    suite = ValidationSuite(toy_spec(VOCAB, device="cpu"), [
        ValidationTask("default", ds.corpus, ds.queries, ds.qrels)], vcfg)
    engine = suite.engine("default")
    calls = []
    _engine_spy(engine, calls)
    run, _, _ = engine.run(params)
    assert calls == ["step"] * engine.doc_store.n_chunks
    plain = ValidationSuite(toy_spec(VOCAB, device="cpu"), [
        ValidationTask("default", ds.corpus, ds.queries, ds.qrels)],
        ValidationConfig(k=20, chunk_size=CHUNK, scan_window=1))
    want, _, _ = plain.engine("default").run(params)
    for qid in want:
        assert set(run[qid]) == set(want[qid])
