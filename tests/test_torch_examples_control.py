"""The torch twins of the control examples, on the CPU at small sizes:
train_with_control, lazy_handoff and observability.

Each twin runs with ``device="cpu"`` and its own asserts hold; then it is
held against the JAX package: the reference's ``replay_ledger`` of the
twin's ledger gives the twin's decisions byte for byte; every
snapshot-scored verdict equals the durable checkpoint's bit for bit; the
reference's ``load_traces`` / ``stage_summary`` read the twin's trace
files and name the same stages.  No time is asserted.
"""

import importlib.util
import json
import os

import pytest

import repro.control as jc
import repro.obs as jobs
from repro.obs import export as jexport
from repro_torch import control as tc
from repro_torch import obs as tobs
from repro_torch.core.suite import (ValidationConfig, ValidationSuite,
                                    ValidationTask)
from repro_torch.core.validator import ValidationLedger, ValidatorWorker
from repro_torch.data import corpus as corpus_lib
from repro_torch.models.toy import toy_spec
from repro_torch.obs import export as texport

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _twin(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(path):
    with open(path) as f:
        return [r for r in (json.loads(line) for line in f if line.strip())
                if "kind" not in r]


def test_train_with_control_twin_replays_in_reference(tmp_path):
    out = _twin("train_with_control_torch").main(
        device="cpu", steps=100, ckpt_every=10, corpus_size=60, n_queries=8,
        workdir=str(tmp_path))
    assert not out["errors"]
    assert out["validated_steps"]
    assert {"select", "gc"} <= set(out["event_kinds"])
    if out["stopped_early"]:
        assert out["stop_verdict"]["reason"] == "plateau"
        assert out["trained_steps"] < 100
    online = [e.to_json() for e in
              jc.ControlEventLog(out["control_path"]).decisions()]
    assert online == [e.to_json() for e in
                      tc.ControlEventLog(out["control_path"]).decisions()]
    rows = _rows(out["ledger_path"])
    for pkg in (jc, tc):
        cfg = pkg.ControlConfig(metric="MRR@10", mode="max", keep_top_k=3,
                                early_stop=True, patience=3, min_delta=1e-4,
                                overfit_window=0, ensemble_top_k=3)
        offline = pkg.replay_ledger(rows, cfg)
        assert [e.to_json() for e in offline.events.decisions()] == online
        assert offline.stopped == out["stopped_early"]


def test_lazy_handoff_twin_snapshot_verdicts_are_durable(tmp_path):
    out = _twin("lazy_handoff_torch").main(
        device="cpu", n_passages=200, n_queries=20, steps=40,
        snapshot_every=10, workdir=str(tmp_path))
    rows = out["rows"]
    assert [r["step"] for r in rows] == [10, 20, 30, 40]
    assert out["n_verdicts"] == 4
    assert out["parity"]["step"] in (10, 20, 30, 40)
    assert out["watcher_p50_s"] > 0 and out["handoff_p50_s"] > 0
    snap = {r["step"]: r["metrics"] for r in rows
            if r.get("handoff") == "snapshot"}
    assert snap and out["n_snapshot"] == len(snap)
    # every snapshot-scored step, re-scored from its durable checkpoint
    ds = corpus_lib.synthetic_retrieval_dataset(0, n_passages=200,
                                                n_queries=20)
    suite = ValidationSuite(toy_spec(ds.vocab, device="cpu"), [
        ValidationTask("default", ds.corpus, ds.queries, ds.qrels)],
        ValidationConfig(metrics=("MRR@10",), k=50, batch_size=64))
    worker = ValidatorWorker(
        out["ckpts_dir"], suite,
        ledger=ValidationLedger(None, expected_tasks=suite.task_names))
    for step, metrics in snap.items():
        assert worker.run_step(step).tasks["default"].metrics == metrics


def test_observability_twin_traces_read_by_reference(tmp_path):
    out = _twin("observability_torch").main(
        device="cpu", n_passages=120, n_queries=16, total_steps=20,
        ckpt_every=10, workdir=str(tmp_path))
    assert out["workers_tracing"] == ["w0", "w1"]
    assert out["n_verdicts"] == 2
    assert set(tobs.LIFECYCLE_STAGES) <= set(out["stages"])
    # the reference's loader also returns the port's `clock` records,
    # which are no stage and which the port's loader leaves out
    jrecords = [r for r in jexport.load_traces(out["traces"])
                if r["kind"] != "clock"]
    trecords = texport.load_traces(out["traces"])
    assert jrecords == trecords
    jsummary = jexport.stage_summary(jrecords)
    tsummary = texport.stage_summary(trecords)
    assert list(jsummary) == list(tsummary)
    assert set(jobs.LIFECYCLE_STAGES) <= set(jsummary)
    for name in jsummary:
        assert jsummary[name]["count"] == tsummary[name]["count"], name
    with open(out["chrome"]) as f:
        assert len(json.load(f)["traceEvents"]) == out["n_events"]
    assert jexport.breakdown_table(jrecords) == \
        texport.breakdown_table(trecords)


@pytest.mark.parametrize("name", ["train_with_control_torch",
                                  "lazy_handoff_torch",
                                  "observability_torch"])
def test_control_twins_raise_without_a_card(name, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        _twin(name)._cli([])
