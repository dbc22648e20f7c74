"""Both CLIs on one checkpoint directory, for the subset and rerank paths.

The JAX package writes two checkpoints of the smoke dr-bert; the JAX CLI
and the port's CLI (``--device cpu``) validate them with
``--engine materialized`` (at every score dtype), ``--mode rerank`` on both
engines (with ``--rerank_block``), ``--mode average_rank`` and
``--token_backing mmap``.  Both encoders compute in f32, as in
tests/test_torch_slice.py, whose encoder hooks these runs use.  The ledgers
must have the same steps, keys, engine and subset size, and metrics within
1e-6; the two mmap caches must be byte-identical.
"""

import json
import os

import jax
import pytest

from repro.ckpt import checkpoint as jckpt
from repro.configs import dr_bert_base as jcfg_mod
from repro.core.cli import main as jax_main
from repro.core.metrics import write_trec_run
from repro.data import corpus as jcorpus
from repro.models import nn as jnn
from repro.models import transformer as jtfm
from repro_torch.core.cli import main as torch_main

STEPS = (10, 20)
HOOKS = "tests.test_torch_slice"


@pytest.fixture(scope="module")
def filespace(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli_modes")
    ds = jcorpus.synthetic_retrieval_dataset(0, n_passages=96, n_queries=12,
                                             vocab=211, p_len=20, q_len=6)
    (base / "corpus").mkdir()
    jcorpus.write_jsonl(str(base / "corpus" / "c.jsonl"), ds.corpus)
    jcorpus.write_jsonl(str(base / "q.jsonl"), ds.queries)
    with open(base / "qrels.txt", "w") as f:
        for qid, docs in ds.qrels.items():
            for did, g in docs.items():
                f.write(f"{qid} 0 {did} {g}\n")
    run = jcorpus.lexical_baseline_run(ds, k=40, drop_frac=0.2)
    write_trec_run(str(base / "bm25.trec"),
                   {q: [d for d, _ in v] for q, v in run.items()},
                   {q: [s for _, s in v] for q, v in run.items()},
                   tag="bm25")
    cfg = jcfg_mod.smoke_config()
    for i, step in enumerate(STEPS):
        params = jnn.materialize(jtfm.init(jax.random.PRNGKey(i + 3), cfg))
        jckpt.save(str(base / "ckpts"), step, {"params": params})
    return base


def _args(base, out, encoder):
    return ["--query_file", str(base / "q.jsonl"),
            "--candidate_dir", str(base / "corpus"),
            "--ckpts_dir", str(base / "ckpts"),
            "--qrel_file", str(base / "qrels.txt"),
            "--q_max_len", "8", "--p_max_len", "24", "--chunk_size", "32",
            "--retrieve_k", "20", "--metrics", "MRR@10", "Recall@20",
            "nDCG@10", "--output_dir", str(out),
            "--encoder", f"{HOOKS}:{encoder}"]


def _ledger(out):
    with open(os.path.join(out, "asyncval_ledger.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _assert_same_ledgers(got, want, engine):
    assert [r["step"] for r in got] == [r["step"] for r in want] \
        == list(STEPS)
    for a, b in zip(got, want):
        assert set(a) == set(b) and set(a["timings"]) == set(b["timings"])
        assert a["engine"] == b["engine"] == engine
        assert (a["subset_size"], a["score_dtype"]) == \
            (b["subset_size"], b["score_dtype"])
        assert a["metrics"].keys() == b["metrics"].keys()
        for name, v in b["metrics"].items():
            assert a["metrics"][name] == pytest.approx(v, abs=1e-6), name


def _run_both(base, tmp_path, jax_extra, port_runs):
    out = tmp_path / "jax"
    assert jax_main(_args(base, out, "jax_encoder") + jax_extra) == 0
    want = _ledger(out)
    for i, extra in enumerate(port_runs):
        out = tmp_path / f"port{i}"
        assert torch_main(_args(base, out, "torch_encoder")
                          + ["--device", "cpu"] + extra) == 0
        yield want, _ledger(out)


@pytest.mark.parametrize("score_dtype", ["f32", "bf16", "int8"])
def test_materialized_engine_matches_jax(filespace, tmp_path, score_dtype):
    common = ["--engine", "materialized", "--score_dtype", score_dtype]
    for want, got in _run_both(filespace, tmp_path,
                               common + ["--impl", "xla"],
                               [common + ["--impl", "torch"],
                                common + ["--impl", "cuda"]]):
        _assert_same_ledgers(got, want, "materialized")
        assert want[0]["subset_size"] == 96


@pytest.mark.parametrize("engine", ["streaming", "materialized"])
def test_rerank_mode_matches_jax(filespace, tmp_path, engine):
    common = ["--mode", "rerank", "--run_file",
              str(filespace / "bm25.trec"), "--depth", "15", "--engine",
              engine]
    port_runs = [common + ["--impl", "cuda"]]
    if engine == "materialized":
        port_runs += [common + ["--rerank_block", "1"],
                      common + ["--rerank_block", "5"]]
    ledgers = list(_run_both(filespace, tmp_path, common, port_runs))
    for want, got in ledgers:
        _assert_same_ledgers(got, want, engine)
        assert want[0]["subset_size"] < 96
    for _, got in ledgers[1:]:                     # block sizes agree exactly
        assert [r["metrics"] for r in got] == \
            [r["metrics"] for r in ledgers[0][1]]


def test_average_rank_mode_matches_jax(filespace, tmp_path):
    common = ["--mode", "average_rank", "--depth", "5"]
    for want, got in _run_both(filespace, tmp_path, common, [common]):
        _assert_same_ledgers(got, want, "streaming")
        assert "AverageRank" in got[0]["metrics"]


def test_mmap_token_backing_matches_jax(filespace, tmp_path):
    common = ["--token_backing", "mmap", "--token_fingerprint", "full",
              "--staging_depth", "3"]
    caches = {side: tmp_path / f"cache_{side}" for side in ("jax", "port")}
    runs = list(_run_both(
        filespace, tmp_path, common + ["--mmap_dir", str(caches["jax"])],
        [common + ["--mmap_dir", str(caches["port"])], common]))
    for want, got in runs:
        _assert_same_ledgers(got, want, "streaming")
    # the second port run took the default <output_dir>/token_cache
    assert os.listdir(tmp_path / "port1" / "token_cache") == ["corpus_tokens"]
    files = {}
    for side, cache in caches.items():
        d = cache / "corpus_tokens"
        files[side] = {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}
    assert files["port"] == files["jax"]
    assert "chunk_hashes.json" in files["port"]
