"""The port's telemetry (``repro_torch.obs``) against the reference's.

Mirrors tests/test_obs.py: the metrics registry, the span tracer, the
Chrome export and stage summaries, the bounded validator fault ring,
BudgetPolicy on shared registry instruments, and the solo validator's
lifecycle spans.  Where the reference module takes the same inputs (seeded
numpy values, the same trace records) the port's output must equal it
exactly.  The reference's two-worker fleet test is mirrored in
tests/test_torch_fleet.py; here the trainer + async validator loop
measures checkpoint-to-verdict from the trainer's ``produced`` mark, and
the port's CLI runs with the ``--obs_*`` flags.
"""

import argparse
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import cli
from repro_torch.core.suite import (ValidationConfig, ValidationSuite,
                                    ValidationTask)
from repro_torch.core.validator import (CKPT_TO_VERDICT_METRIC,
                                        AsyncValidator, ErrorRing,
                                        ValidatorWorker)
from repro_torch.core.watcher import (CHECKPOINT_CADENCE_METRIC,
                                      DISCOVERY_LAG_METRIC,
                                      VALIDATION_LATENCY_METRIC,
                                      BudgetPolicy, CheckpointWatcher)
from repro_torch.data import corpus as synthetic_ds
from repro_torch.models.biencoder import EncoderSpec
from repro_torch.obs import (LIFECYCLE_STAGES, Counter, Ewma, Gauge,
                             Histogram, MetricsRegistry, SpanTracer,
                             Telemetry, read_trace)
from repro_torch.obs import export as obs_export

DIM = 8
VOCAB = 97


def _toy_encode(params, tokens, mask):
    emb = params["table"][tokens.long()]
    m = mask.to(emb.dtype)[..., None]
    v = (emb * m).sum(1) / torch.clamp(m.sum(1), min=1e-6)
    return v / torch.clamp(v.norm(dim=-1, keepdim=True), min=1e-6)


def _toy_init(seed):
    rng = np.random.default_rng(seed)
    return {"table": rng.standard_normal((VOCAB, DIM)).astype(np.float32)}


def toy_spec():
    return EncoderSpec(name="toy", dim=DIM, encode_query=_toy_encode,
                       encode_passage=_toy_encode, init=_toy_init,
                       param_shapes={"table": (VOCAB, DIM)},
                       device=torch.device("cpu"), q_max_len=8, p_max_len=12)


@pytest.fixture(scope="module")
def ds():
    return synthetic_ds.synthetic_retrieval_dataset(7, n_passages=40,
                                                    n_queries=8, vocab=VOCAB)


def _suite(ds, **kw):
    vcfg = ValidationConfig(metrics=("MRR@10",), batch_size=8, **kw)
    return ValidationSuite(toy_spec(), [
        ValidationTask("default", ds.corpus, ds.queries, ds.qrels)], vcfg)


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

def test_counter_gauge_basics():
    c = Counter("c")
    c.inc()
    c.inc(3)
    assert c.value == 4
    assert c.snapshot() == {"type": "counter", "value": 4}
    g = Gauge("g")
    assert g.value is None
    g.set(2.5)
    assert g.snapshot() == {"type": "gauge", "value": 2.5}


def test_ewma_matches_reference_rule():
    """Seeded values through the port's and the reference's Ewma: every
    estimate equal."""
    values = np.random.default_rng(0).exponential(size=50)
    for smooth in (0.0, 0.5, 0.9):
        e, je = Ewma("e", smooth=smooth), jmetrics.Ewma("e", smooth=smooth)
        assert e.value is None
        for v in values:
            e.update(v)
            je.update(v)
            assert e.value == je.value
        assert e.snapshot() == je.snapshot()
    e = Ewma("e", smooth=0.5)
    e.update(4.0)
    e.update(8.0)
    assert e.value == 0.5 * 4.0 + 0.5 * 8.0 and e.count == 2


def test_histogram_percentiles_nearest_rank():
    h = Histogram("h")
    for v in [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0]:
        h.observe(v)
    assert h.count == 10
    assert h.mean == pytest.approx(5.5)
    assert h.percentile(50) == 5.0
    assert h.percentile(99) == 10.0
    assert h.vmin == 1.0 and h.vmax == 10.0
    assert Histogram("empty").percentile(50) is None
    # seeded values: the reference's percentiles and snapshot exactly
    values = np.random.default_rng(1).lognormal(size=300)
    h, jh = Histogram("h", maxlen=128), jmetrics.Histogram("h", maxlen=128)
    for v in values:
        h.observe(v)
        jh.observe(v)
    for p in (1, 10, 50, 90, 99, 100):
        assert h.percentile(p) == jh.percentile(p)
    assert h.snapshot() == jh.snapshot()


def test_histogram_reservoir_is_bounded():
    h = Histogram("h", maxlen=4)
    for v in range(100):
        h.observe(float(v))
    assert h.count == 100
    assert h.percentile(50) == 97.0


def test_registry_shares_instruments_and_rejects_type_conflicts():
    reg = MetricsRegistry()
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")
    assert reg.get("x").value == 0
    assert reg.get("never-created") is None
    assert reg.names() == ["x"]


def test_registry_snapshot_dump_render_match_reference(tmp_path):
    regs = (MetricsRegistry(), jmetrics.MetricsRegistry())
    for reg in regs:
        reg.counter("a.count").inc(2)
        reg.histogram("b.lat_s").observe(0.5)
        reg.histogram("b.lat_s").observe(0.25)
        reg.ewma("c.ema").update(1.0)
        reg.gauge("d.g").set(3.0)
    out = tmp_path / "metrics.json"
    regs[0].dump(str(out))
    regs[1].dump(str(tmp_path / "ref.json"))
    assert out.read_bytes() == (tmp_path / "ref.json").read_bytes()
    snap = json.loads(out.read_text())
    assert snap["a.count"] == {"type": "counter", "value": 2}
    assert regs[0].render() == regs[1].render()
    for name in ("metric", "a.count", "b.lat_s", "c.ema"):
        assert name in regs[0].render()


# ---------------------------------------------------------------------------
# Span tracer
# ---------------------------------------------------------------------------

def test_span_nesting_parent_child(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tr = SpanTracer(path, process="p0", attrs={"worker_id": "w0"})
    with tr.span("scored", step=3, task="default") as outer:
        with tr.span("encoded", role="query") as inner:
            tr.event("published", step=3)
        tr.record("staged", time.monotonic() - 0.25, 0.25, n_batches=4)
    tr.flush()
    recs = {r["name"]: r for r in read_trace(path)}
    assert recs["scored"]["parent"] is None
    assert recs["encoded"]["parent"] == recs["scored"]["id"]
    assert recs["staged"]["parent"] == recs["scored"]["id"]
    assert recs["published"]["parent"] == recs["encoded"]["id"]
    assert recs["published"]["kind"] == "event"
    assert recs["scored"]["dur"] >= recs["encoded"]["dur"]
    assert all(r["worker_id"] == "w0" and r["process"] == "p0"
               for r in recs.values())
    assert recs["scored"]["step"] == 3
    assert outer.id != inner.id


def test_span_records_exception_and_propagates(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tr = SpanTracer(path)
    with pytest.raises(ValueError):
        with tr.span("scored", step=1):
            raise ValueError("boom")
    tr.flush()
    (rec,) = read_trace(path)
    assert "ValueError" in rec["error"]


def test_tracer_buffers_until_flush(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tr = SpanTracer(path, flush_every=1000)
    tr.event("produced", step=1)
    assert not os.path.exists(path)
    tr.flush()
    assert len(read_trace(path)) == 1
    tr.flush()
    assert len(read_trace(path)) == 1


def test_threads_do_not_adopt_each_others_spans(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tr = SpanTracer(path)
    ready = threading.Event()
    release = threading.Event()

    def other():
        ready.wait(5)
        tr.event("discovered", step=9)
        release.set()

    t = threading.Thread(target=other)
    t.start()
    with tr.span("scored", step=1):
        ready.set()
        release.wait(5)
    t.join()
    tr.flush()
    recs = {r["name"]: r for r in read_trace(path)}
    assert recs["discovered"]["parent"] is None


def test_disabled_telemetry_is_noop(tmp_path):
    tel = Telemetry(None)
    assert tel.tracer is None
    with tel.span("scored", step=1):
        pass
    with tel.span("scored", step=2):
        pass
    tel.event("produced", step=1)
    tel.record("staged", 0.0, 1.0)
    tel.flush()
    assert os.listdir(tmp_path) == []
    tel.metrics.counter("still.works").inc()
    assert tel.metrics.get("still.works").value == 1


def test_mark_since_cross_stage_latency():
    tel = Telemetry(None)
    assert tel.since("discovered", 5) is None
    tel.mark("discovered", 5)
    lag = tel.since("discovered", 5)
    assert lag is not None and lag >= 0.0
    assert tel.since("discovered", 5, pop=True) is not None
    assert tel.since("discovered", 5) is None


# ---------------------------------------------------------------------------
# Chrome export + stage summaries
# ---------------------------------------------------------------------------

def test_chrome_export_round_trip_matches_reference(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tr = SpanTracer(path, process="worker-0")
    with tr.span("scored", step=1, task="default"):
        tr.event("published", step=1)
    tr.flush()
    out = str(tmp_path / "chrome.json")
    doc = obs_export.write_chrome([path], out)
    loaded = json.loads(open(out).read())
    assert loaded == doc
    # the reference's exporter reads the port's trace to the same document
    assert jexport.to_chrome(jexport.load_traces([path])) == doc
    phases = [e["ph"] for e in loaded["traceEvents"]]
    assert "M" in phases and "X" in phases and "i" in phases
    span = next(e for e in loaded["traceEvents"] if e["ph"] == "X")
    assert span["name"] == "scored" and span["cat"] == "lifecycle"
    assert span["dur"] >= 1.0
    assert span["args"]["step"] == 1 and span["args"]["task"] == "default"
    inst = next(e for e in loaded["traceEvents"] if e["ph"] == "i")
    assert inst["args"]["parent_id"] == span["args"]["span_id"]


def _seeded_records(seed=0, n=40):
    rng = np.random.default_rng(seed)
    names = list(LIFECYCLE_STAGES)
    recs, open_ids = [], []
    for i in range(1, n + 1):
        name = names[int(rng.integers(len(names)))]
        parent = open_ids[int(rng.integers(len(open_ids)))] \
            if open_ids and rng.random() < 0.6 else None
        if rng.random() < 0.3:
            recs.append({"kind": "event", "name": name, "id": i,
                         "parent": parent, "t": float(rng.random()),
                         "pid": 1, "_file": "f"})
        else:
            recs.append({"kind": "span", "name": name, "id": i,
                         "parent": parent, "t0": float(rng.random()),
                         "dur": float(rng.random() * 0.1), "pid": 1,
                         "_file": "f"})
            open_ids.append(i)
    return recs


def test_stage_summary_self_time_excludes_children():
    recs = [
        {"kind": "span", "name": "scored", "id": 1, "parent": None,
         "t0": 0.0, "dur": 1.0, "pid": 1, "_file": "f"},
        {"kind": "span", "name": "encoded", "id": 2, "parent": 1,
         "t0": 0.1, "dur": 0.4, "pid": 1, "_file": "f"},
        {"kind": "event", "name": "published", "id": 3, "parent": None,
         "t": 0.0, "pid": 1, "_file": "f"},
    ]
    summary = obs_export.stage_summary(recs)
    assert summary["scored"]["self_s"] == pytest.approx(0.6)
    assert summary["published"]["count"] == 1
    order = [ln.split()[0] for ln in
             obs_export.breakdown_table(recs).splitlines()[2:]]
    assert order == ["published", "encoded", "scored"]
    # seeded records: the reference's summary and table exactly
    for seed in range(3):
        recs = _seeded_records(seed)
        assert obs_export.stage_summary(recs) == jexport.stage_summary(recs)
        assert obs_export.breakdown_table(recs) == \
            jexport.breakdown_table(recs)


def test_export_cli_merges_files(tmp_path, capsys):
    p0, p1 = str(tmp_path / "w0.jsonl"), str(tmp_path / "w1.jsonl")
    for i, p in enumerate((p0, p1)):
        tr = SpanTracer(p, process=f"worker-{i}")
        with tr.span("scored", step=i):
            pass
        tr.flush()
    out = str(tmp_path / "chrome.json")
    assert obs_export.main([p0, p1, "--chrome", out, "--summary"]) == 0
    assert "scored" in capsys.readouterr().out
    doc = json.loads(open(out).read())
    names = {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert names == {"worker-0", "worker-1"}


# ---------------------------------------------------------------------------
# ErrorRing
# ---------------------------------------------------------------------------

def test_error_ring_caps_and_counts_drops():
    ring = ErrorRing(maxlen=3)
    for i in range(5):
        ring.append((i, f"e{i}"))
    assert len(ring) == 3 and ring.dropped == 2
    assert [e[0] for e in ring] == [2, 3, 4]
    assert ring[-1] == (4, "e4")
    assert ring[:2] == [(2, "e2"), (3, "e3")]
    c = Counter("validator.errors_dropped")
    ring.bind_counter(c)
    assert c.value == 2
    ring.append((5, "e5"))
    assert c.value == 3
    ring.clear()
    assert not ring and len(ring) == 0


def test_worker_error_ring_is_bounded(ds, tmp_path):
    tel = Telemetry(None)
    w = ValidatorWorker(str(tmp_path), _suite(ds), telemetry=tel,
                        max_errors=2)
    for i in range(4):
        w.errors.append((i, "x"))
    assert len(w.errors) == 2
    assert tel.metrics.get("validator.errors_dropped").value == 2


# ---------------------------------------------------------------------------
# BudgetPolicy on shared registry instruments
# ---------------------------------------------------------------------------

def test_budget_policy_feeds_shared_registry():
    reg = MetricsRegistry()
    pol = BudgetPolicy(smooth=0.5)
    pol.bind_metrics(reg)
    pol.observe_latency(4.0)
    pol.observe_cadence(1.0)
    lat = reg.get(VALIDATION_LATENCY_METRIC)
    cad = reg.get(CHECKPOINT_CADENCE_METRIC)
    assert lat.value == 4.0 and cad.value == 1.0
    pol.observe_latency(8.0)
    assert lat.value == 0.5 * 4.0 + 0.5 * 8.0
    assert pol.select([10])


def test_budget_policy_rebind_carries_state_over():
    pol = BudgetPolicy(smooth=0.5)
    pol.observe_latency(4.0)
    reg = MetricsRegistry()
    pol.bind_metrics(reg)
    assert reg.get(VALIDATION_LATENCY_METRIC).value == 4.0
    assert reg.get(VALIDATION_LATENCY_METRIC).count == 1


def test_watcher_binds_policy_and_observes_discovery(tmp_path):
    root = str(tmp_path / "ckpts")
    tel = Telemetry(str(tmp_path / "trace.jsonl"))
    watcher = CheckpointWatcher(root, policy=BudgetPolicy(), telemetry=tel)
    assert tel.metrics.get(CHECKPOINT_CADENCE_METRIC) is not None
    ckpt.save(root, 10, {"params": {"x": np.zeros(2, np.float32)}})
    assert watcher.poll() == [10]
    tel.flush()
    recs = [r for r in read_trace(str(tmp_path / "trace.jsonl"))
            if r["name"] == "discovered"]
    assert len(recs) == 1 and recs[0]["step"] == 10
    assert tel.metrics.get(DISCOVERY_LAG_METRIC).count == 1
    assert tel.since("discovered", 10) is not None


# ---------------------------------------------------------------------------
# Solo validator end to end
# ---------------------------------------------------------------------------

def test_solo_validator_traces_full_lifecycle(ds, tmp_path):
    root = str(tmp_path / "ckpts")
    ckpt.save(root, 5, {"params": _toy_init(0)})
    trace = str(tmp_path / "trace.jsonl")
    tel = Telemetry(trace, attrs={"worker_id": "solo"})
    suite = _suite(ds)
    av = AsyncValidator(root, suite, telemetry=tel,
                        ledger_path=str(tmp_path / "ledger.jsonl"))
    assert av.validate_pending() == 1
    tel.flush()
    recs = read_trace(trace)
    names = {r["name"] for r in recs}
    assert {"discovered", "store_build", "staged", "encoded", "scored",
            "recorded"} <= names
    # one scored span per (step, task); the engine spans nest under it
    scored = [r for r in recs if r["name"] == "scored"]
    assert [(r["step"], r["task"]) for r in scored] == [(5, "default")]
    for r in recs:
        if r["name"] in ("staged", "encoded"):
            assert r["parent"] == scored[0]["id"]
    hist = tel.metrics.get(CKPT_TO_VERDICT_METRIC)
    assert hist is not None and hist.count == 1
    assert suite.vcfg.telemetry is tel
    # a `chunk` span per chunk, with its trunk's and fold's device time,
    # and a `staged` span per staged batch of chunks
    chunks = [r for r in recs if r["name"] == "chunk"]
    staged = [r for r in recs if r["name"] == "staged"]
    assert sorted(r["chunk"] for r in chunks) == list(range(len(chunks)))
    assert sum(r["n"] for r in staged) == len(chunks) >= 1
    assert all(r["parent"] == scored[0]["id"] and r["trunk_s"] > 0
               and r["fold_s"] > 0 for r in chunks)


def _normalized(path):
    """The ledger's bytes with every timing value set to 0 (they vary run
    to run): keys, order and every other value are kept as written."""
    out = []
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            row["timings"] = {k: 0.0 for k in row["timings"]}
            out.append(json.dumps(row))
    return "\n".join(out).encode()


def test_disabled_telemetry_identical_ledger(ds, tmp_path):
    """Telemetry on or off, the ledger holds the same bytes apart from the
    timing values; off writes no trace file."""

    def run(workdir, tel):
        root = os.path.join(workdir, "ckpts")
        for step in (5, 6):
            ckpt.save(root, step, {"params": _toy_init(step)})
        led = os.path.join(workdir, "ledger.jsonl")
        av = AsyncValidator(root, _suite(ds), telemetry=tel, ledger_path=led)
        assert av.validate_pending() == 2
        return led

    off = run(str(tmp_path / "off"), None)
    on_dir = str(tmp_path / "on")
    on = run(on_dir, Telemetry(os.path.join(on_dir, "trace.jsonl")))
    assert _normalized(off) == _normalized(on)
    assert not any(f.endswith("trace.jsonl")
                   for f in os.listdir(str(tmp_path / "off")))


def test_trainer_produced_mark_times_checkpoint_to_verdict(ds, tmp_path):
    """Trainer + async validator sharing one Telemetry: one ``produced``
    event per checkpoint, and the checkpoint-to-verdict histogram measured
    from the trainer's mark for every verdict."""
    from repro_torch.train import optim
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tel = Telemetry(str(tmp_path / "trace.jsonl"))
    root = str(tmp_path / "ckpts")
    spec = toy_spec()
    suite = _suite(ds, telemetry=tel)
    qids = sorted(ds.qrels)

    def batches(step):
        rng = np.random.default_rng(step)
        pick = rng.choice(len(qids), size=4)
        qt, qm = synthetic_ds.pad_batch([ds.queries[qids[i]] for i in pick],
                                        spec.q_max_len)
        pt, pm = synthetic_ds.pad_batch(
            [ds.corpus[next(iter(ds.qrels[qids[i]]))] for i in pick],
            spec.p_max_len)
        return {k: torch.from_numpy(v) for k, v in (
            ("q_tokens", qt), ("q_mask", qm), ("p_tokens", pt[:, None]),
            ("p_mask", pm[:, None]))}

    from repro_torch.models.biencoder import contrastive_loss
    tr = Trainer(TrainerConfig(total_steps=6, ckpt_every=2, ckpt_dir=root,
                               log_every=2),
                 lambda p, b: contrastive_loss(p, spec, b),
                 optim.adamw(1e-2),
                 {"table": torch.from_numpy(_toy_init(0)["table"])}, batches,
                 telemetry=tel)
    av = AsyncValidator(root, suite, telemetry=tel, poll_interval_s=0.01,
                        ledger_path=str(tmp_path / "ledger.jsonl"))
    av.start()
    tr.run()
    av.stop(drain=True)
    assert av.ledger.validated_steps == [2, 4, 6] and not av.errors
    tel.flush()
    produced = [r for r in read_trace(str(tmp_path / "trace.jsonl"))
                if r["name"] == "produced"]
    assert [r["step"] for r in produced] == [2, 4, 6]
    assert all(r["async_save"] is True for r in produced)
    hist = tel.metrics.get(CKPT_TO_VERDICT_METRIC)
    assert hist.count == 3 and hist.vmin > 0


def test_lifecycle_vocabulary_is_stable():
    from repro.obs import LIFECYCLE_STAGES as JSTAGES
    assert LIFECYCLE_STAGES == JSTAGES == (
        "produced", "snapshotted", "discovered", "published", "claimed",
        "store_build", "staged", "encoded", "scored", "recorded",
        "selected", "promoted", "served")


def test_obs_report_prints_verdict_percentiles(capsys):
    tel = Telemetry(None)
    for v in (0.1, 0.2, 0.3):
        tel.metrics.histogram(CKPT_TO_VERDICT_METRIC).observe(v)
    cli._obs_finish(argparse.Namespace(obs_report=True, obs_metrics=None),
                    tel)
    out = capsys.readouterr().out
    assert "checkpoint-to-verdict" in out
    assert "p50=" in out and "p99=" in out
    assert CKPT_TO_VERDICT_METRIC in out


def test_cli_obs_flags_end_to_end(ds, tmp_path, capsys):
    """``--obs_trace``, ``--obs_report`` and ``--obs_metrics`` on the
    port's CLI: a trace with the lifecycle spans, the report, the metrics
    snapshot; the ledger equals a run without them but for its timings."""
    (tmp_path / "corpus").mkdir()
    synthetic_ds.write_jsonl(str(tmp_path / "corpus" / "c.jsonl"), ds.corpus)
    synthetic_ds.write_jsonl(str(tmp_path / "q.jsonl"), ds.queries)
    with open(tmp_path / "qrels.txt", "w") as f:
        for qid, docs in ds.qrels.items():
            for did, g in docs.items():
                f.write(f"{qid} 0 {did} {g}\n")
    for step in (1, 2):
        ckpt.save(str(tmp_path / "ckpts"), step, {"params": _toy_init(step)})

    def args(out):
        return ["--query_file", str(tmp_path / "q.jsonl"),
                "--candidate_dir", str(tmp_path / "corpus"),
                "--ckpts_dir", str(tmp_path / "ckpts"),
                "--qrel_file", str(tmp_path / "qrels.txt"),
                "--q_max_len", "8", "--p_max_len", "12", "--batch_size", "8",
                "--encoder", "tests.test_torch_obs:cli_encoder",
                "--device", "cpu", "--output_dir", str(out)]

    assert cli.main(args(tmp_path / "plain")) == 0
    trace, snap = tmp_path / "trace.jsonl", tmp_path / "metrics.json"
    assert cli.main(args(tmp_path / "obs") + [
        "--obs_trace", str(trace), "--obs_report", "--obs_metrics",
        str(snap)]) == 0
    out = capsys.readouterr().out
    assert "checkpoint-to-verdict: p50=" in out and "over 2 verdicts" in out
    names = [r["name"] for r in read_trace(str(trace))]
    assert names.count("scored") == 2 and names.count("discovered") == 2
    assert {"store_build", "staged", "encoded", "recorded"} <= set(names)
    assert all(r["run"] == "asyncval" for r in read_trace(str(trace)))
    assert json.loads(snap.read_text())[CKPT_TO_VERDICT_METRIC]["count"] == 2
    assert _normalized(tmp_path / "plain" / "asyncval_ledger.jsonl") == \
        _normalized(tmp_path / "obs" / "asyncval_ledger.jsonl")


def cli_encoder(args):
    """--encoder hook for the CLI test: the toy bag-of-embeddings."""
    return toy_spec()


# ---------------------------------------------------------------------------
# Spans that never touch a query's path
# ---------------------------------------------------------------------------

def test_emit_writes_no_file_on_an_emitting_thread(tmp_path, monkeypatch):
    """Emitting only buffers: the file is written by the tracer's writer
    thread once ``flush_every`` records wait, or by ``flush()``, never by
    a thread that emits a span."""
    from repro_torch.obs import trace as obs_trace
    writers = []
    real = obs_trace.append_jsonl_atomic

    def spy(path, recs):
        writers.append(threading.current_thread().name)
        return real(path, recs)

    monkeypatch.setattr(obs_trace, "append_jsonl_atomic", spy)
    path = str(tmp_path / "trace.jsonl")
    quiet = SpanTracer(path, flush_every=10_000)
    for i in range(500):
        quiet.record("queued", time.monotonic(), 0.0, qid=str(i))
    assert writers == [] and not os.path.exists(path)
    quiet.flush()
    assert writers == ["MainThread"]

    writers.clear()
    tr = SpanTracer(str(tmp_path / "busy.jsonl"), flush_every=8)

    def emit(k):
        for i in range(200):
            tr.record("queued", time.monotonic(), 0.0, qid=f"{k}.{i}")

    threads = [threading.Thread(target=emit, args=(k,), name=f"client-{k}")
               for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    tr.flush()
    assert writers and set(writers) <= {"span-writer", "MainThread"}
    assert len(read_trace(str(tmp_path / "busy.jsonl"))) == 1600


def test_clock_record_puts_a_span_on_the_wall_clock(tmp_path):
    """A ``clock`` record maps a span's monotonic ``t0`` to
    ``time.time_ns()`` within a millisecond."""
    from repro_torch.obs import to_time_ns
    path = str(tmp_path / "trace.jsonl")
    tr = SpanTracer(path, process="p0")
    time.sleep(0.05)
    # the tightest of a few (monotonic, time_ns) brackets: a preempted
    # thread reads a wide one
    m0, ns, m1 = min(((time.monotonic(), time.time_ns(), time.monotonic())
                      for _ in range(20)), key=lambda r: r[2] - r[0])
    t0 = 0.5 * (m0 + m1)
    tr.record("served", t0, 0.01)
    tr.flush()
    clocks = [r for r in read_trace(path, clocks=True)
              if r["kind"] == "clock"]
    assert len(clocks) == 2            # at creation, and with the write
    assert all(r["process"] == "p0" for r in clocks)
    (span,) = read_trace(path)
    assert abs(to_time_ns(span["t0"], clocks) - ns) < 1_000_000
    # clock records are no stage of a summary
    assert set(obs_export.stage_summary(
        read_trace(path, clocks=True))) == {"served"}


def _toy_index(seed=0, n=300):
    from repro_torch.serve.index import ServingIndex
    g = torch.Generator().manual_seed(seed)
    emb = torch.nn.functional.normalize(torch.randn(n, DIM, generator=g),
                                        dim=1)
    params = {"table": torch.from_numpy(_toy_init(seed)["table"])}
    return ServingIndex(step=3, params=params,
                        doc_ids=[f"d{i}" for i in range(n)], emb=emb,
                        n_docs=n, score_dtype="f32", impl="cuda",
                        block=64, build_s=0.0)


def test_traced_query_service_answers_every_query(tmp_path):
    """512 queries from 64 threads through a traced service: every one is
    answered; one ``queued`` span per query, from its submit to its
    batch's dispatch; each batch's ``served`` span, with its ``encoded``
    and ``topk`` children, ends after its answers were released."""
    from repro_torch.serve.service import QueryService
    path = str(tmp_path / "trace.jsonl")
    tel = Telemetry(path)
    svc = QueryService(toy_spec(), k=5, max_batch=8, flush_ms=2.0,
                       telemetry=tel)
    svc.install(_toy_index())
    svc.start()
    rng = np.random.default_rng(0)
    queries = {f"q{i}": rng.integers(1, VOCAB, size=int(rng.integers(2, 8)))
               .tolist() for i in range(512)}
    results = {}
    barrier = threading.Barrier(64)

    def client(k):
        barrier.wait(10)
        for i in range(k, 512, 64):
            qid = f"q{i}"
            results[qid] = svc.submit(qid, queries[qid], timeout=60)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    svc.stop()
    tel.flush()
    assert sorted(results) == sorted(queries)
    assert all(r.qid == q and len(r.doc_ids) == 5 for q, r in results.items())
    recs = read_trace(path)
    queued = [r for r in recs if r["name"] == "queued"]
    assert sorted(r["qid"] for r in queued) == sorted(queries)
    served = {r["id"]: r for r in recs if r["name"] == "served"}
    assert len(served) == svc.batches
    assert tel.metrics.get("serve.trace_dropped") is None
    for r in queued:
        s = served[r["batch"]]
        assert r["dur"] >= 0 and r["t0"] + r["dur"] == pytest.approx(s["t0"])
        # the answer was made (t0 + latency_s) before the span ended
        assert s["t0"] + s["dur"] > r["t0"] + results[r["qid"]].latency_s
    for name in ("encoded", "topk"):
        kids = [r for r in recs if r["name"] == name]
        assert sorted(r["parent"] for r in kids) == sorted(served)
        assert all(r["dev_s"] > 0 for r in kids)
    assert all(0 < r["issue_s"] <= r["dur"]
               for r in recs if r["name"] == "topk")


@pytest.mark.parametrize("impl,window", [("cuda", 1), ("torch", 1),
                                         ("torch", 8)])
def test_streaming_engine_spans_per_chunk(ds, tmp_path, impl, window):
    """A ``staged`` span per staged batch and a ``chunk`` span per chunk,
    with its trunk's and fold's device intervals in order, all nested
    under ``scored``; the ``encoded`` corpus loop covers them."""
    tel = Telemetry(str(tmp_path / "trace.jsonl"))
    suite = _suite(ds, telemetry=tel, impl=impl, scan_window=window,
                   chunk_size=8)
    suite.validate_params(_toy_init(1), step=1)
    tel.flush()
    recs = read_trace(str(tmp_path / "trace.jsonl"))
    (scored,) = [r for r in recs if r["name"] == "scored"]
    chunks = sorted((r for r in recs if r["name"] == "chunk"),
                    key=lambda r: r["chunk"])
    staged = [r for r in recs if r["name"] == "staged"]
    (loop,) = [r for r in recs if r.get("role") == "corpus"]
    assert [r["chunk"] for r in chunks] == list(range(5))
    assert len(staged) == (5 if window == 1 else 2)
    assert sum(r["n"] for r in staged) == 5
    for r in chunks + staged + [loop]:
        assert r["parent"] == scored["id"]
    for a, b in zip(chunks, chunks[1:]):
        assert a["dev_t0"] + a["dev_s"] <= b["dev_t0"]
    for r in chunks:
        assert r["trunk_s"] > 0 and r["fold_s"] > 0
        assert r["trunk_s"] + r["fold_s"] == pytest.approx(r["dev_s"])
        assert loop["t0"] <= r["dev_t0"]
        assert r["dev_t0"] + r["dev_s"] <= loop["t0"] + loop["dur"]
    assert len([r for r in recs if r["name"] == "uploaded"]) == 1
    # the exporter draws each chunk's trunk and fold on a device track
    events = obs_export.to_chrome(recs)["traceEvents"]
    (track,) = [e for e in events if e["name"] == "thread_name"]
    assert track["args"]["name"] == "device"
    dev = [e for e in events if e.get("cat") == "device"]
    assert all(e["tid"] == track["tid"] for e in dev)
    assert sorted(e["name"] for e in dev) == ["fold"] * 5 + ["trunk"] * 5


def test_no_cuda_event_without_telemetry(ds, tmp_path, monkeypatch):
    """With ``telemetry=None`` neither the engine nor the service makes a
    CUDA event."""
    from repro_torch.serve.service import QueryService

    def refuse(*a, **k):
        raise AssertionError("a CUDA event with telemetry off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    root = str(tmp_path / "ckpts")
    ckpt.save(root, 1, {"params": _toy_init(1)})
    w = ValidatorWorker(root, _suite(ds, impl="cuda"))
    assert w.run_step(1).tasks["default"].metrics
    svc = QueryService(toy_spec(), k=5, max_batch=4)
    svc.install(_toy_index())
    svc.start()
    try:
        assert len(svc.submit("q", [1, 2, 3], timeout=30).doc_ids) == 5
    finally:
        svc.stop()
    assert len(svc.answer([("a", [4, 5]), ("b", [6])])) == 2
