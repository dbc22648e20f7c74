"""The paper's subset tooling in the port against the JAX package's.

Baseline runs (the lexical "BM25" stand-in and the oracle-plus-noise
"strong DR") are identical for one seed; the splitter CLI writes the
reference splitter's file byte for byte; ``write_subset_jsonl``, the
fidelity statistics and ``MemoryLogger`` equal the reference's; and the
``ValidationPipeline`` façade gives the reference's metrics at retrieval,
rerank and average-rank modes (f32 toy encoder, within 1e-6).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fidelity as jfid
from repro.core import metrics as jmetrics
from repro.core import reporting as jreporting
from repro.core import samplers as jsamplers
from repro.core.pipeline import ValidationConfig as JaxConfig
from repro.core.pipeline import ValidationPipeline as JaxPipeline
from repro.core.registry import resolve_sampler as jax_resolve_sampler
from repro.core.splitter import main as jax_splitter
from repro.data import corpus as jcorpus
from repro.models.biencoder import EncoderSpec as JaxSpec
from repro_torch.core import fidelity, reporting, samplers
from repro_torch.core.pipeline import ValidationConfig, ValidationPipeline
from repro_torch.core.registry import resolve_sampler
from repro_torch.core.splitter import main as splitter
from repro_torch.data import corpus
from repro_torch.models.biencoder import EncoderSpec

VOCAB, DIM = 211, 16


@pytest.fixture(scope="module")
def ds():
    return corpus.synthetic_retrieval_dataset(0, n_passages=240,
                                              n_queries=20, vocab=VOCAB)


@pytest.mark.parametrize("kw", [dict(k=50), dict(k=10, drop_frac=0.3,
                                                 seed=4),
                                dict(k=300, drop_frac=0.9, seed=1)])
def test_lexical_baseline_run_matches_jax(ds, kw):
    jds = jcorpus.synthetic_retrieval_dataset(0, n_passages=240,
                                              n_queries=20, vocab=VOCAB)
    assert corpus.lexical_baseline_run(ds, **kw) == \
        jcorpus.lexical_baseline_run(jds, **kw)


@pytest.mark.parametrize("kw", [dict(noise=0.3), dict(noise=1.5, seed=3,
                                                      k=20),
                                dict(noise=0.5, k=40, overlap_weight=0.8)])
def test_oracle_noisy_baseline_run_matches_jax(ds, kw):
    jds = jcorpus.synthetic_retrieval_dataset(0, n_passages=240,
                                              n_queries=20, vocab=VOCAB)
    assert corpus.oracle_noisy_baseline_run(ds, **kw) == \
        jcorpus.oracle_noisy_baseline_run(jds, **kw)


@pytest.fixture(scope="module")
def files(ds, tmp_path_factory):
    base = tmp_path_factory.mktemp("subset")
    (base / "corpus").mkdir()
    items = list(ds.corpus.items())
    corpus.write_jsonl(str(base / "corpus" / "a.jsonl"), dict(items[:100]))
    corpus.write_jsonl(str(base / "corpus" / "b.jsonl"), dict(items[100:]))
    with open(base / "qrels.txt", "w") as f:
        for qid, docs in ds.qrels.items():
            for did, g in docs.items():
                f.write(f"{qid} 0 {did} {g}\n")
    run = corpus.lexical_baseline_run(ds, k=50, drop_frac=0.2)
    jmetrics.write_trec_run(str(base / "bm25.trec"),
                            {q: [d for d, _ in v] for q, v in run.items()},
                            {q: [s for _, s in v] for q, v in run.items()},
                            tag="bm25")
    return base


@pytest.mark.parametrize("depth", [5, 30])
def test_splitter_cli_writes_the_reference_file(files, ds, tmp_path, depth):
    outs = {}
    for side, main in (("jax", jax_splitter), ("port", splitter)):
        out = tmp_path / side
        assert main(["--candidate_dir", str(files / "corpus"),
                     "--run_file", str(files / "bm25.trec"),
                     "--qrel_file", str(files / "qrels.txt"),
                     "--output_dir", str(out), "--depth", str(depth)]) == 0
        assert os.listdir(out) == [f"subset_top{depth}.jsonl"]
        with open(out / f"subset_top{depth}.jsonl", "rb") as f:
            outs[side] = f.read()
    assert outs["port"] == outs["jax"]
    kept = corpus.read_jsonl(str(tmp_path / "port" /
                                 f"subset_top{depth}.jsonl"))
    assert 0 < len(kept) < len(ds.corpus)
    assert {d for q in ds.qrels.values() for d in q} <= set(kept)


def test_splitter_module_runs_as_main(files, tmp_path):
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.splitter",
         "--candidate_dir", str(files / "corpus"), "--run_file",
         str(files / "bm25.trec"), "--qrel_file", str(files / "qrels.txt"),
         "--output_dir", str(tmp_path), "--depth", "3"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "[splitter]" in proc.stderr
    assert os.path.exists(tmp_path / "subset_top3.jsonl")


def test_write_subset_jsonl_matches_jax(ds, tmp_path):
    run = corpus.lexical_baseline_run(ds, k=30)
    sub = samplers.RunFileTopK(depth=8).sample(list(ds.corpus), run,
                                               ds.qrels)
    jsub = jsamplers.RunFileTopK(depth=8).sample(list(ds.corpus), run,
                                                 ds.qrels)
    samplers.write_subset_jsonl(sub, ds.corpus, str(tmp_path / "p.jsonl"))
    jsamplers.write_subset_jsonl(jsub, ds.corpus, str(tmp_path / "j.jsonl"))
    with open(tmp_path / "p.jsonl", "rb") as a, \
            open(tmp_path / "j.jsonl", "rb") as b:
        assert a.read() == b.read()
    back = corpus.read_jsonl(str(tmp_path / "p.jsonl"))
    assert list(back) == sub.doc_ids
    assert all(back[d] == ds.corpus[d] for d in back)


_SERIES = {
    "tracking": ([0.10, 0.15, 0.21, 0.22, 0.30], [0.31, 0.35, 0.40, 0.39,
                                                  0.52]),
    "inverted": ([1.0, 2.0, 3.0, 4.0], [4.0, 3.0, 2.0, 1.0]),
    "ties": ([0.2, 0.2, 0.3, 0.1, 0.3], [0.5, 0.4, 0.4, 0.4, 0.6]),
    "constant": ([0.5, 0.5, 0.5], [0.1, 0.2, 0.3]),
    "underestimates": ([0.4, 0.5], [0.3, 0.55]),
}


@pytest.mark.parametrize("name", sorted(_SERIES))
@pytest.mark.parametrize("higher", [True, False])
def test_fidelity_matches_jax(name, higher):
    a, b = _SERIES[name]
    for fn in ("pearson", "spearman", "kendall_tau"):
        assert getattr(fidelity, fn)(a, b) == getattr(jfid, fn)(a, b), fn
    assert fidelity._ranks(b) == jfid._ranks(b)
    assert fidelity.best_checkpoint_agreement(a, b, higher) == \
        jfid.best_checkpoint_agreement(a, b, higher)
    assert fidelity.overestimation(a, b) == jfid.overestimation(a, b)
    assert fidelity.fidelity_report(a, b, higher) == \
        jfid.fidelity_report(a, b, higher)


def test_memory_logger_matches_jax():
    mine, ref = reporting.MemoryLogger(), jreporting.MemoryLogger()
    for lg in (mine, ref):
        metrics = {"MRR@10": 0.25, "engine": "streaming"}
        lg.log(10, metrics)
        metrics["MRR@10"] = 0.5                   # the logger keeps a copy
        lg.log(20, metrics)
        lg.close()
    assert mine.records == ref.records == [
        (10, {"MRR@10": 0.25, "engine": "streaming"}),
        (20, {"MRR@10": 0.5, "engine": "streaming"})]
    assert isinstance(mine, reporting.BaseLogger)


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


@pytest.mark.parametrize("mode,engine,sampler,depth", [
    ("retrieval", "streaming", "run_topk", 10),
    ("retrieval", "materialized", "full", 0),
    ("rerank", "streaming", "rerank_topk", 20),
    ("rerank", "materialized", "rerank_topk", 20),
    ("average_rank", "streaming", "qrel_pool", 5)])
def test_pipeline_matches_jax(ds, mode, engine, sampler, depth):
    table = np.random.default_rng(6).normal(size=(VOCAB, DIM)) \
        .astype(np.float32)
    baseline = corpus.lexical_baseline_run(ds, k=40)
    kw = dict(metrics=("MRR@10", "Recall@20"), mode=mode, k=20,
              batch_size=32, chunk_size=48, engine=engine)
    jpipe = JaxPipeline(
        JaxSpec(name="toy", dim=DIM, encode_query=_jax_toy,
                encode_passage=_jax_toy, init=None, q_max_len=8,
                p_max_len=20),
        ds.corpus, ds.queries, ds.qrels, JaxConfig(**kw),
        sampler=jax_resolve_sampler(sampler, depth=depth),
        baseline_run=baseline)
    pipe = ValidationPipeline(
        EncoderSpec(name="toy", dim=DIM, encode_query=_torch_toy,
                    encode_passage=_torch_toy, init=None,
                    param_shapes={"table": (VOCAB, DIM)},
                    device=torch.device("cpu"), q_max_len=8, p_max_len=20),
        ds.corpus, ds.queries, ds.qrels, ValidationConfig(**kw),
        sampler=resolve_sampler(sampler, depth=depth),
        baseline_run=baseline)
    assert pipe.doc_ids == jpipe.doc_ids
    assert pipe.sampler_name == jpipe.sampler_name
    got = pipe.validate_params({"table": table}, step=3)
    want = jpipe.validate_params({"table": jnp.asarray(table)}, step=3)
    assert (got.step, got.engine, got.subset_size, got.task) == \
        (want.step, want.engine, want.subset_size, want.task)
    assert got.metrics.keys() == want.metrics.keys()
    assert ("AverageRank" in got.metrics) == (mode == "average_rank")
    for name, v in want.metrics.items():
        assert got.metrics[name] == pytest.approx(v, abs=1e-6), name
