"""The torch twins of the loop examples, on the CPU at small sizes:
quickstart, async_vs_sync, subset_fidelity and multi_task_validation.

Each twin runs with ``device="cpu"`` and its own asserts hold; then the
JAX package validates the checkpoints (or, for subset_fidelity, the
snapshots) the twin wrote, with its own suite on its own copy of the
data, and must give the twin's metrics within 1e-6 and the same subset
sizes exactly.  No time is asserted.
"""

import importlib.util
import os

import numpy as np
import pytest

from benchmarks.common import toy_spec as jtoy_spec
from repro.core.fidelity import fidelity_report as jfidelity_report
from repro.core.pipeline import ValidationConfig as JPipeConfig
from repro.core.pipeline import ValidationPipeline as JPipeline
from repro.core.samplers import FullCorpus as JFullCorpus
from repro.core.samplers import RunFileTopK as JRunFileTopK
from repro.core.suite import ValidationConfig as JConfig
from repro.core.suite import ValidationSuite as JSuite
from repro.core.suite import ValidationTask as JTask
from repro.core.validator import AsyncValidator as JValidator
from repro.data import corpus as jcorpus

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
TOL = 1e-6


def _twin(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_metrics(ckdir, suite):
    """The JAX validator over a checkpoint directory the port wrote ->
    {step: metrics}, with each row's subset size."""
    v = JValidator(ckdir, suite)
    v.validate_pending()
    return {r.step: (dict(r.metrics), r.subset_size) for r in v.results}


def _assert_close(got, want):
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name] == pytest.approx(value, abs=TOL), name


def test_quickstart_twin_matches_reference(tmp_path):
    out = _twin("quickstart_torch").main(
        device="cpu", n_passages=300, n_queries=20, steps=20,
        snapshot_every=10, workdir=str(tmp_path))
    assert [r["step"] for r in out["results"]] == [0, 10, 20]
    assert out["n_chunks"] == -(-out["subset_size"] // 128)
    assert os.path.exists(out["ledger_path"])
    ds = jcorpus.synthetic_retrieval_dataset(0, n_passages=300, n_queries=20)
    baseline = jcorpus.lexical_baseline_run(ds, k=100)
    names = ("MRR@10", "Recall@100")
    suite = JSuite(jtoy_spec(ds.vocab), [
        JTask("default", ds.corpus, ds.queries, ds.qrels,
              sampler=JRunFileTopK(depth=20), baseline_run=baseline,
              metrics=names, k=100)],
        JConfig(metrics=names, k=100, batch_size=128, chunk_size=128))
    want = _reference_metrics(out["ckpts_dir"], suite)
    for r in out["results"]:
        _assert_close(r["metrics"], want[r["step"]][0])
        assert r["subset_size"] == want[r["step"]][1] == out["subset_size"]


def test_quickstart_twin_cuda_impl_on_cpu_tensors(tmp_path):
    """``impl="cuda"`` on the CPU takes the kernel wrapper's plain version
    and gives the torch route's metrics."""
    twin = _twin("quickstart_torch")
    kw = dict(device="cpu", n_passages=200, n_queries=12, steps=10,
              snapshot_every=10)
    a = twin.main(impl="torch", workdir=str(tmp_path / "t"), **kw)
    b = twin.main(impl="cuda", workdir=str(tmp_path / "c"), **kw)
    for ra, rb in zip(a["results"], b["results"]):
        _assert_close(rb["metrics"], ra["metrics"])


def test_async_vs_sync_twin_matches_reference(tmp_path):
    out = _twin("async_vs_sync_torch").main(
        device="cpu", n_ckpts=2, steps_per_ckpt=10, corpus_size=300,
        n_queries=20, depth=20, workdir=str(tmp_path))
    rows = {r["mode"]: r for r in out["rows"]}
    assert set(rows) == {"sync", "async"}
    assert out["speedup"] > 0
    ds = jcorpus.synthetic_retrieval_dataset(0, n_passages=300, n_queries=20)
    baseline = jcorpus.lexical_baseline_run(ds, k=20)
    for mode, row in rows.items():
        assert row["n_validated"] == 2
        assert sorted(row["metrics"]) == [10, 20]
        pipe = JPipeline(jtoy_spec(ds.vocab), ds.corpus, ds.queries,
                         ds.qrels, JPipeConfig(metrics=("MRR@10",), k=100,
                                               batch_size=128),
                         sampler=JRunFileTopK(depth=20),
                         baseline_run=baseline)
        want = _reference_metrics(row["ckpts_dir"], pipe)
        for step, metrics in row["metrics"].items():
            _assert_close(metrics, want[step][0])
            assert row["subset_size"] == want[step][1]
        assert row["mrr_last"] == pytest.approx(want[20][0]["MRR@10"],
                                                abs=TOL)
    # both modes train from one seed: the same checkpoints, one verdict
    assert rows["sync"]["metrics"] == rows["async"]["metrics"]


def test_subset_fidelity_twin_matches_reference():
    kw = dict(corpus_size=400, n_queries=20, n_ckpts=3, steps_per_ckpt=5,
              depths=(10, 50))
    out = _twin("subset_fidelity_torch").main(device="cpu", **kw)
    fid = out["fidelity"]
    assert out["steps"] == [0, 5, 10, 15]
    assert sorted(fid) == ["full", "strong_top10", "strong_top50",
                           "weak_top10", "weak_top50"]
    ds = jcorpus.synthetic_retrieval_dataset(
        0, n_passages=400, n_queries=20, n_topics=60, vocab=1009,
        topic_frac_p=0.35, topic_frac_q=0.5)
    weak = jcorpus.lexical_baseline_run(ds, k=50, drop_frac=0.4)
    strong = jcorpus.oracle_noisy_baseline_run(ds, noise=0.3,
                                               overlap_weight=0.75, k=50)
    snaps = [(s, {"table": p["table"].numpy()}) for s, p in out["snapshots"]]
    spec = jtoy_spec(ds.vocab)
    vcfg = JPipeConfig(metrics=("MRR@10",), k=100, batch_size=128)

    def curve(sampler, baseline):
        pipe = JPipeline(spec, ds.corpus, ds.queries, ds.qrels, vcfg,
                         sampler=sampler, baseline_run=baseline)
        return ([pipe.validate_params(p, step=s).metrics["MRR@10"]
                 for s, p in snaps], pipe.subset.size)

    full, size = curve(JFullCorpus(), None)
    np.testing.assert_allclose(fid["full"]["curve"], full, rtol=0, atol=TOL)
    assert fid["full"]["size"] == size == 400
    for name, baseline in (("weak", weak), ("strong", strong)):
        for d in (10, 50):
            got = fid[f"{name}_top{d}"]
            c, size = curve(JRunFileTopK(depth=d), baseline)
            np.testing.assert_allclose(got["curve"], c, rtol=0, atol=TOL)
            assert got["size"] == size
            rep = jfidelity_report(fid["full"]["curve"], got["curve"])
            for key, value in rep.items():
                assert got[key] == pytest.approx(value, abs=1e-12), key


def test_multi_task_twin_matches_reference(tmp_path):
    out = _twin("multi_task_validation_torch").main(
        device="cpu", n_passages=300, n_queries=20, steps=20,
        snapshot_every=10, workdir=str(tmp_path))
    rows = out["rows"]
    assert [(r["step"], r["task"]) for r in rows] == \
        [(s, t) for s in (0, 10, 20) for t in ("dev", "heldout")]
    assert out["best_step"] in (0, 10, 20)
    ds = jcorpus.synthetic_retrieval_dataset(0, n_passages=300, n_queries=20)
    qids = sorted(ds.queries)
    cut = len(qids) // 2

    def split(ids):
        return ({q: ds.queries[q] for q in ids},
                {q: ds.qrels[q] for q in ids if q in ds.qrels})
    (dq, dr), (hq, hr) = split(qids[:cut]), split(qids[cut:])
    suite = JSuite(jtoy_spec(ds.vocab), [
        JTask("dev", ds.corpus, dq, dr, metrics=("MRR@10", "Recall@100"),
              k=100),
        JTask("heldout", ds.corpus, hq, hr, metrics=("MRR@10",), k=100)],
        JConfig(batch_size=128, chunk_size=128))
    want = _reference_metrics(out["ckpts_dir"], suite)
    for r in rows:
        ref_metrics, ref_size = want[r["step"]]
        got = {f"{r['task']}:{k}": v for k, v in r["metrics"].items()}
        _assert_close(got, {k: v for k, v in ref_metrics.items()
                            if k.startswith(r["task"] + ":")})
        assert r["subset_size"] == 300


@pytest.mark.parametrize("name", ["quickstart_torch", "async_vs_sync_torch",
                                  "subset_fidelity_torch",
                                  "multi_task_validation_torch"])
def test_loop_twins_raise_without_a_card(name, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        _twin(name)._cli([])
