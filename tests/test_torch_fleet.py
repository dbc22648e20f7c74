"""The port's validator fleet: ``ValidatorWorker``'s claim loop,
``repro_torch.launch.fleet`` and the CLI's ``--worker`` mode.

Mirrors tests/test_fleet.py:249-857 on the port: the forced-crash reclaim
and replay, two workers splitting a backlog, a capability mismatch, a
failing unit abandoned until its budget, a solo validator writing no fleet
records, ``flatten_rows`` completion grouping, the stop and drain
timeouts, the supervisor's ``extra_protect``, two real CLI workers through
``python -m repro_torch.launch.fleet ... --device cpu`` and a SIGKILLed
worker; and tests/test_handoff.py:642 (the supervisor publishing snapshot
units) and tests/test_obs.py:437 (per-worker trace attribution).

Across the packages: a two-worker port fleet over checkpoints that the JAX
trainer saved writes result rows whose metrics equal a solo port run's
exactly, its rows carry both workers' ids, and both packages'
``replay_ledger`` give byte-identical control decisions from its ledger.
Everything runs on the CPU.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from benchmarks.common import toy_spec as jtoy_spec
from benchmarks.common import train_toy_dr as jtrain_toy_dr
import repro.control as jcontrol
import repro.core.workqueue as jwq
from repro.ckpt import checkpoint as jckpt
from repro.data import corpus as jcorpus
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.control import ControlConfig, ControlPlane, replay_ledger
from repro_torch.control.metricspec import flatten_rows
from repro_torch.core import cli
from repro_torch.core.jsonl import read_jsonl_tolerant
from repro_torch.core.suite import (ValidationConfig, ValidationResult,
                                    ValidationSuite, ValidationTask)
from repro_torch.core.validator import (CKPT_TO_VERDICT_METRIC,
                                        AsyncValidator, ValidationLedger,
                                        ValidatorWorker)
from repro_torch.core.workqueue import WorkQueue, WorkUnit, replay
from repro_torch.data import corpus as corpus_lib
from repro_torch.handoff import ParamSnapshot, SnapshotSpool
from repro_torch.launch.fleet import FleetSupervisor
from repro_torch.models.toy import toy_spec
from repro_torch.obs import Telemetry
from repro_torch.obs import export as obs_export

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
STUB_TEMPLATE = {"params": {"x": (1,)}}


# ---------------------------------------------------------------------------
# In-process fleet mechanics (a deterministic pipeline, no encoder)
# ---------------------------------------------------------------------------

class _FakeFleetPipeline:
    """Deterministic two-task pipeline for fleet mechanics."""

    task_names = ("default", "deep")

    def plan_units(self, step):
        return [WorkUnit.make(step, "default"),
                WorkUnit.make(step, "deep", {"mesh_size": 2})]

    def run_unit(self, params, unit, engine=None, write_runs=None):
        return ValidationResult(
            step=unit.step, metrics={"MRR@10": 0.01 * unit.step},
            timings={"total_s": 0.001}, subset_size=3, engine="fake",
            task=unit.task)

    def validate_params(self, params, step=0, engine=None, write_runs=None):
        raise AssertionError("fleet path must go through run_unit")


def _commit_stub_ckpt(root, step):
    ckpt.save(root, step, {"params": {"x": np.zeros(1, np.float32)}})


def _make_worker(root, ledger_path, wid, pipeline, lease_ttl=4):
    queue = WorkQueue(ledger_path, wid, capabilities={"mesh_size": 2},
                      lease_ttl=lease_ttl)
    return ValidatorWorker(
        root, pipeline,
        ledger=ValidationLedger(ledger_path,
                                expected_tasks=pipeline.task_names),
        queue=queue, worker_id=wid, template=STUB_TEMPLATE,
        params_extractor=lambda state: state["params"])


def test_forced_crash_fleet_reclaim_and_replay(tmp_path):
    """Worker A claims a unit and dies; the survivor B reclaims the
    expired lease, the step completes with every task's row, both
    packages' replay_ledger reproduce the online decisions byte for byte,
    and the claimed checkpoint was GC-protected while A's lease was
    live."""
    root = str(tmp_path / "ck")
    ledger_path = str(tmp_path / "ledger.jsonl")
    pipe = _FakeFleetPipeline()
    _commit_stub_ckpt(root, 1)
    ccfg = ControlConfig(metric="MRR@10")
    control = ControlPlane(None, ccfg)
    sup = FleetSupervisor(root, ledger_path, pipe.task_names,
                          control=control, plan_units=pipe.plan_units,
                          lease_ttl=4)
    assert sup.publish_pending() == 2
    worker_a = _make_worker(root, ledger_path, "A", pipe)
    worker_b = _make_worker(root, ledger_path, "B", pipe)
    deep = worker_a.queue.refresh().units[(1, "deep")].unit
    assert worker_a.queue.try_claim(deep)
    assert 1 in sup.protect_set()
    assert not sup.step_complete(1)
    for _ in range(30):
        worker_b.run_once()
        sup.pump_control()
        if sup.step_complete(1):
            break
    assert sup.step_complete(1)
    assert [u.key for u in worker_b.completed] == [(1, "default"),
                                                   (1, "deep")]
    reclaims = [e for e in worker_b.queue.state.events
                if e["event"] == "reclaim"]
    assert reclaims and reclaims[0]["from"] == "A" \
        and reclaims[0]["worker"] == "B"
    led = ValidationLedger(ledger_path, expected_tasks=pipe.task_names)
    assert led.validated_steps == [1]
    assert {r["worker_id"] for r in led.rows()} == {"B"}
    assert led.tasks_for(1) == ["deep", "default"]
    assert 1 not in sup.protect_set()
    offline = replay(ledger_path, lease_ttl=4)
    assert offline.events == worker_b.queue.refresh().events
    online = [e.to_json() for e in control.events.decisions()]
    assert online
    replayed = replay_ledger(led.rows(), ccfg, expected_tasks=pipe.task_names,
                             group="completion")
    assert online == [e.to_json() for e in replayed.events.decisions()]
    jreplayed = jcontrol.replay_ledger(
        led.rows(), jcontrol.ControlConfig(metric="MRR@10"),
        expected_tasks=pipe.task_names, group="completion")
    assert online == [e.to_json() for e in jreplayed.events.decisions()]


def test_two_workers_split_backlog(tmp_path):
    root = str(tmp_path / "ck")
    ledger_path = str(tmp_path / "ledger.jsonl")
    pipe = _FakeFleetPipeline()
    workers = [_make_worker(root, ledger_path, wid, pipe, lease_ttl=32)
               for wid in ("A", "B")]
    for step in (1, 2, 3):
        _commit_stub_ckpt(root, step)
        workers[0].queue.publish(pipe.plan_units(step))
    for _ in range(40):
        done = sum(w.run_once() for w in workers)
        if not done and not workers[0].queue.refresh().claimable({}):
            break
    assert len(replay(ledger_path, lease_ttl=32).completed_units()) == 6
    by_worker = {}
    for r in ValidationLedger(ledger_path).rows():
        by_worker.setdefault(r["worker_id"], []).append(r["step"])
    assert set(by_worker) == {"A", "B"}
    assert sum(len(v) for v in by_worker.values()) == 6


def test_two_worker_threads_run_forever_until_drained(tmp_path):
    """Two claim loops on two threads drain one backlog: every unit
    completed exactly once."""
    root = str(tmp_path / "ck")
    ledger_path = str(tmp_path / "ledger.jsonl")
    pipe = _FakeFleetPipeline()
    workers = [_make_worker(root, ledger_path, wid, pipe, lease_ttl=64)
               for wid in ("A", "B")]
    for step in range(1, 6):
        _commit_stub_ckpt(root, step)
        workers[0].queue.publish(pipe.plan_units(step))
    stop = threading.Event()

    def drained():
        st = replay(ledger_path, lease_ttl=64)
        return len(st.completed_units()) == 10

    threads = [threading.Thread(target=w.run_forever, args=(stop,),
                                kwargs={"idle_wait_s": 0.01,
                                        "drained": drained})
               for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stop.set()
    assert not any(t.is_alive() for t in threads)
    st = replay(ledger_path, lease_ttl=64)
    assert len(st.completed_units()) == 10
    rows, _ = read_jsonl_tolerant(ledger_path)
    results = [(r["step"], r["task"]) for r in rows if "kind" not in r]
    assert sorted(results) == st.completed_units()     # each unit once
    assert {r["worker_id"] for r in rows if "kind" not in r} <= {"A", "B"}


def test_capability_mismatch_keeps_unit_for_big_worker(tmp_path):
    root = str(tmp_path / "ck")
    ledger_path = str(tmp_path / "ledger.jsonl")
    pipe = _FakeFleetPipeline()
    _commit_stub_ckpt(root, 1)
    small = _make_worker(root, ledger_path, "small", pipe)
    small.queue.capabilities = {"mesh_size": 1}
    big = _make_worker(root, ledger_path, "big", pipe)
    small.queue.publish(pipe.plan_units(1))
    while small.run_once():
        pass
    assert [u.key for u in small.completed] == [(1, "default")]
    assert big.queue.refresh().units[(1, "deep")].status == "open"
    assert big.run_once() == 1
    assert [u.key for u in big.completed] == [(1, "deep")]


def test_worker_abandons_failing_unit_until_budget(tmp_path):
    class _Failing(_FakeFleetPipeline):
        def run_unit(self, params, unit, engine=None, write_runs=None):
            raise RuntimeError("engine wedged")

    root = str(tmp_path / "ck")
    ledger_path = str(tmp_path / "ledger.jsonl")
    _commit_stub_ckpt(root, 1)
    w = _make_worker(root, ledger_path, "A", _Failing())
    w.queue.max_abandons = 1
    w.queue.state.max_abandons = 1
    w.queue.publish([WorkUnit.make(1, "default")])
    for _ in range(5):
        w.run_once()
    assert w.queue.refresh().units[(1, "default")].status == "failed"
    assert len(w.errors) == 2
    assert ValidationLedger(ledger_path).rows() == []


def test_run_once_needs_a_queue(tmp_path):
    w = ValidatorWorker(str(tmp_path), _FakeFleetPipeline(),
                        template=STUB_TEMPLATE)
    with pytest.raises(RuntimeError, match="WorkQueue"):
        w.run_once()


def test_workers_own_cuda_streams(monkeypatch):
    """On a card each worker runs its units on a stream of its own,
    created once (engine.synchronize then waits for that worker's work
    only); on the CPU there is no stream."""
    created, entered = [], []

    class _FakeStream:
        def __init__(self, device):
            created.append(self)

    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: entered.append(s) or _NullCtx())

    class _NullCtx:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class _Spec:
        device = torch.device("cuda", 0)

    class _OnCard(_FakeFleetPipeline):
        spec = _Spec()

    a = ValidatorWorker("ck", _OnCard(), template=STUB_TEMPLATE)
    b = ValidatorWorker("ck", _OnCard(), template=STUB_TEMPLATE)
    for w in (a, b, a):
        with w.own_stream():
            pass
    assert len(created) == 2 and entered == [created[0], created[1],
                                             created[0]]
    cpu = ValidatorWorker("ck", _FakeFleetPipeline(), template=STUB_TEMPLATE)
    with cpu.own_stream():
        pass
    assert len(created) == 2


# ---------------------------------------------------------------------------
# The solo validator is unchanged
# ---------------------------------------------------------------------------

class _Solo(_FakeFleetPipeline):
    task_names = ("default",)

    def validate_params(self, params, step=0, engine=None, write_runs=None):
        return self.run_unit(params, WorkUnit.make(step, "default"))


def test_solo_validator_writes_no_fleet_records(tmp_path):
    root = str(tmp_path / "ck")
    ledger_path = str(tmp_path / "ledger.jsonl")
    _commit_stub_ckpt(root, 3)
    v = AsyncValidator(root, _Solo(), ledger_path=ledger_path,
                       template=STUB_TEMPLATE,
                       params_extractor=lambda s: s["params"])
    assert v.validate_pending() == 1
    raw, torn = read_jsonl_tolerant(ledger_path)
    assert torn is None
    assert all("kind" not in r and "worker_id" not in r for r in raw)
    assert list(raw[0]) == ["step", "task", "metrics", "timings",
                            "subset_size", "engine", "score_dtype"]


def test_async_validator_with_workqueue_protects_live_claims(tmp_path):
    """A solo validator sharing a fleet's ledger keeps GC off steps under
    another worker's live lease and stamps its rows with its id."""
    root = str(tmp_path / "ck")
    ledger_path = str(tmp_path / "ledger.jsonl")
    for step in (1, 2):
        _commit_stub_ckpt(root, step)
    peer = WorkQueue(ledger_path, "peer", lease_ttl=50)
    peer.publish([WorkUnit.make(2)])
    assert peer.try_claim(WorkUnit.make(2))
    v = AsyncValidator(root, _Solo(), ledger_path=ledger_path,
                       template=STUB_TEMPLATE, worker_id="solo",
                       workqueue=WorkQueue(ledger_path, "solo",
                                           lease_ttl=50),
                       params_extractor=lambda s: s["params"])
    assert v.validate_step(1) == 1
    assert v.protect_set() == {2}
    assert [r["worker_id"] for r in v.ledger.rows()] == ["solo"]


def test_flatten_rows_completion_grouping_and_worker_ctx():
    rows = [
        {"step": 1, "task": "a", "metrics": {"m": 0.1}, "worker_id": "A",
         "engine": "fake", "score_dtype": "f32"},
        {"step": 2, "task": "a", "metrics": {"m": 0.3}, "worker_id": "B",
         "engine": "fake", "score_dtype": "f32"},
        {"kind": "tick", "worker": "B"},
        {"step": 2, "task": "b", "metrics": {"m": 0.4}, "worker_id": "B",
         "engine": "fake", "score_dtype": "f32"},
        {"step": 1, "task": "b", "metrics": {"m": 0.2}, "worker_id": "B",
         "engine": "fake", "score_dtype": "f32"},
    ]
    assert [s for s, _ in flatten_rows(rows, ("a", "b"))] == [2]
    obs = flatten_rows(rows, ("a", "b"), with_context=True,
                       group="completion")
    assert [(s, sorted(f)) for s, f, _ in obs] == [
        (2, ["a:m", "b:m"]), (1, ["a:m", "b:m"])]
    assert obs[0][2]["worker_id"] == "B"
    assert obs[1][2]["worker_id"] == "A,B"
    legacy = flatten_rows([{"step": 1, "task": "a", "metrics": {"m": 1.0},
                            "engine": "e", "score_dtype": "f32"}],
                          ("a",), with_context=True)
    assert "worker_id" not in legacy[0][2]
    with pytest.raises(ValueError, match="completion"):
        flatten_rows([], None, group="completion")
    with pytest.raises(ValueError, match="grouping"):
        flatten_rows([], ("a",), group="bogus")


# ---------------------------------------------------------------------------
# stop(drain=True) must not hang on a wedged engine
# ---------------------------------------------------------------------------

def _wedged(release):
    class _Wedged(_FakeFleetPipeline):
        task_names = ("default",)

        def validate_params(self, params, step=0, engine=None,
                            write_runs=None):
            release.wait(30.0)                  # a stuck device dispatch
            return _FakeFleetPipeline.run_unit(
                self, params, WorkUnit.make(step, "default"))
    return _Wedged()


def test_stop_drain_timeout_surfaces_wedged_run(tmp_path):
    root = str(tmp_path / "ck")
    _commit_stub_ckpt(root, 1)
    release = threading.Event()
    v = AsyncValidator(root, _wedged(release), template=STUB_TEMPLATE,
                       params_extractor=lambda s: s["params"])
    t0 = time.monotonic()
    v.stop(drain=True, drain_timeout=0.3)
    assert time.monotonic() - t0 < 5.0
    assert any(key == "stop" and "timed out" in msg
               for key, msg in v.errors)
    release.set()


def test_stop_drain_timeout_bounds_wedged_loop_thread(tmp_path):
    root = str(tmp_path / "ck")
    _commit_stub_ckpt(root, 1)
    release = threading.Event()
    v = AsyncValidator(root, _wedged(release), poll_interval_s=0.01,
                       template=STUB_TEMPLATE,
                       params_extractor=lambda s: s["params"])
    v.start()
    time.sleep(0.2)
    t0 = time.monotonic()
    v.stop(drain=True, drain_timeout=0.3)
    assert time.monotonic() - t0 < 5.0
    assert any(key == "stop" for key, _ in v.errors)
    release.set()


def test_stop_without_timeout_still_drains(tmp_path):
    root = str(tmp_path / "ck")
    _commit_stub_ckpt(root, 1)
    v = AsyncValidator(root, _Solo(), template=STUB_TEMPLATE,
                       params_extractor=lambda s: s["params"])
    v.start()
    v.stop(drain=True)
    assert v.ledger.validated_steps == [1]


# ---------------------------------------------------------------------------
# The supervisor: serving-tier GC protection, snapshot units
# ---------------------------------------------------------------------------

def test_supervisor_extra_protect_shields_serving_checkpoint(tmp_path):
    root = str(tmp_path / "ck")
    ledger_path = str(tmp_path / "ledger.jsonl")
    pipe = _FakeFleetPipeline()
    serving = {"steps": set()}
    sup = FleetSupervisor(root, ledger_path, pipe.task_names,
                          plan_units=pipe.plan_units,
                          extra_protect=lambda: serving["steps"])
    w = _make_worker(root, ledger_path, "A", pipe, lease_ttl=32)
    for step in (1, 2):
        _commit_stub_ckpt(root, step)
    sup.publish_pending()
    while w.run_once():
        pass
    assert sup.step_complete(1) and sup.step_complete(2)
    assert sup.protect_set() == set()
    serving["steps"] = {1}
    assert sup.protect_set() == {1}
    serving["steps"] = {1, 2}
    assert sup.protect_set() == {1, 2}


DIM, VOCAB = 8, 120


def _toy_encode(params, tokens, mask):
    emb = params["table"][tokens.long()]
    m = mask.to(emb.dtype)[..., None]
    return (emb * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


@pytest.fixture(scope="module")
def small_ds():
    return corpus_lib.synthetic_retrieval_dataset(7, n_passages=90,
                                                  n_queries=10, vocab=VOCAB)


def _small_suite(ds, names=("default",), telemetry=None):
    from repro_torch.models.biencoder import EncoderSpec
    spec = EncoderSpec(
        name="toy", dim=DIM, encode_query=_toy_encode,
        encode_passage=_toy_encode,
        init=lambda seed: {"table": np.random.default_rng(seed)
                           .standard_normal((VOCAB, DIM))
                           .astype(np.float32)},
        param_shapes={"table": (VOCAB, DIM)}, device=torch.device("cpu"),
        q_max_len=10, p_max_len=26)
    return ValidationSuite(spec, [
        ValidationTask(n, ds.corpus, ds.queries, ds.qrels) for n in names],
        ValidationConfig(metrics=("MRR@10",), k=10, batch_size=16,
                         telemetry=telemetry))


def test_fleet_supervisor_publishes_snapshot_units(tmp_path, small_ds):
    root = str(tmp_path / "ck")
    os.makedirs(root)
    spool = SnapshotSpool(str(tmp_path / "sp"))
    queue_path = str(tmp_path / "queue.jsonl")
    sup = FleetSupervisor(root, queue_path, ("default",),
                          snapshots=SnapshotSpool(spool.root))
    suite = _small_suite(small_ds)
    state = {"params": {k: torch.from_numpy(v)
                        for k, v in suite.spec.init(0).items()}}
    snap = ParamSnapshot.from_tree(1, state)
    spool.publish(1, snap.leaves, snap.treedef_hex, dtypes=snap.dtypes)
    assert sup.publish_pending() == 1
    assert sup.queue.refresh().units[(1, "default")].source == "snapshot"
    ckpt.save(root, 1, state)
    assert sup.publish_pending() == 0
    worker = ValidatorWorker(
        root, suite,
        ledger=ValidationLedger(queue_path, expected_tasks=suite.task_names),
        queue=WorkQueue(queue_path, "w0"), worker_id="w0",
        snapshots=SnapshotSpool(spool.root))
    assert worker.run_once() == 1
    rows = worker.ledger.rows()
    assert rows[0]["handoff"] == "snapshot"
    assert rows[0]["worker_id"] == "w0"
    with open(queue_path) as f:
        first = f.readline()
    assert '"source": "snapshot"' in first


def test_two_worker_fleet_trace_attribution(tmp_path, small_ds):
    """One ``scored`` span per (step, task) across the fleet, attributed to
    the worker whose ledger row it is; the fleet counters mirrored on
    every worker's registry."""
    root = str(tmp_path / "ckpts")
    for step in (1, 2):
        ckpt.save(root, step, {"params": _small_suite(small_ds)
                               .spec.init(step)})
    ledger_path = str(tmp_path / "ledger.jsonl")

    def make_worker(wid):
        trace = str(tmp_path / f"{wid}.jsonl")
        tel = Telemetry(trace, process=wid, attrs={"worker_id": wid})
        suite = _small_suite(small_ds, ("a", "b"), telemetry=tel)
        queue = WorkQueue(ledger_path, wid, lease_ttl=16,
                          capabilities={"mesh_size": 1}, telemetry=tel)
        worker = ValidatorWorker(
            root, suite,
            ledger=ValidationLedger(ledger_path,
                                    expected_tasks=suite.task_names,
                                    telemetry=tel),
            queue=queue, worker_id=wid, telemetry=tel)
        return worker, suite, tel, trace

    w0, suite0, tel0, trace0 = make_worker("w0")
    w1, _, tel1, trace1 = make_worker("w1")
    for step in (1, 2):
        w0.queue.publish(suite0.plan_units(step))
    for _ in range(16):
        if len(w0.completed) + len(w1.completed) == 4:
            break
        w0.run_once()
        w1.run_once()
    assert len(w0.completed) + len(w1.completed) == 4
    assert w0.completed and w1.completed
    w0.queue.refresh()
    w1.queue.refresh()
    tel0.flush()
    tel1.flush()
    records = obs_export.load_traces([trace0, trace1])
    scored = [r for r in records
              if r["name"] == "scored" and r["kind"] == "span"]
    assert sorted((r["step"], r["task"]) for r in scored) == \
        [(1, "a"), (1, "b"), (2, "a"), (2, "b")]
    rows = ValidationLedger(ledger_path).rows()
    by_unit = {(row["step"], row["task"]): row["worker_id"] for row in rows}
    for r in scored:
        assert r["worker_id"] == by_unit[(r["step"], r["task"])]
        assert r["process"] == r["worker_id"]
    names = {r["name"] for r in records}
    assert {"published", "claimed", "store_build", "scored",
            "recorded"} <= names
    claimed = [r for r in records if r["name"] == "claimed"]
    assert {(r["step"], r["task"]) for r in claimed} == \
        {(1, "a"), (1, "b"), (2, "a"), (2, "b")}
    for r in claimed:
        assert r["worker_id"] == by_unit[(r["step"], r["task"])]
    for tel in (tel0, tel1):
        assert tel.metrics.get("fleet.publish").value == 4
        assert tel.metrics.get("fleet.complete").value == 4
    assert sum(t.metrics.get("fleet.claim").value
               for t in (tel0, tel1)) >= 4
    assert sum(t.metrics.get(CKPT_TO_VERDICT_METRIC).count
               for t in (tel0, tel1)
               if t.metrics.get(CKPT_TO_VERDICT_METRIC)) == 4
    doc = obs_export.write_chrome([trace0, trace1],
                                  str(tmp_path / "fleet.json"))
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e["ph"] == "M"}
    assert tracks == {"w0", "w1"}


# ---------------------------------------------------------------------------
# Over the JAX trainer's checkpoints: in-process parity and real workers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Corpus + queries + qrels files and 3 checkpoints that the JAX
    package trains (``benchmarks.common.train_toy_dr``) and saves."""
    base = tmp_path_factory.mktemp("fleet")
    ds = jcorpus.synthetic_retrieval_dataset(0, n_passages=200,
                                             n_queries=20)
    cdir = base / "corpus"
    cdir.mkdir()
    corpus_lib.write_jsonl(str(cdir / "split0.jsonl"), ds.corpus)
    qfile = base / "queries.jsonl"
    corpus_lib.write_jsonl(str(qfile), ds.queries)
    qrels = base / "qrels.txt"
    with open(qrels, "w") as f:
        for qid, docs in ds.qrels.items():
            for did, g in docs.items():
                f.write(f"{qid} 0 {did} {g}\n")
    jspec = jtoy_spec(ds.vocab)
    _, snaps = jtrain_toy_dr(ds, jspec, steps=40, snapshot_every=20)
    ckdir = base / "ckpts"
    for step, params in snaps:
        jckpt.save(str(ckdir), step, {"params": params})
    return {"base": base, "ds": ds, "corpus_dir": cdir, "queries": qfile,
            "qrels": qrels, "ckpts": ckdir,
            "steps": ckpt.list_steps(str(ckdir))}


def _two_task_suite(ds):
    spec = toy_spec(ds.vocab, device="cpu")
    return ValidationSuite(spec, [
        ValidationTask("a", ds.corpus, ds.queries, ds.qrels),
        ValidationTask("b", ds.corpus, ds.queries, ds.qrels,
                       metrics=("MRR@10", "Recall@20"))],
        ValidationConfig(metrics=("MRR@10",), k=50, batch_size=32))


def test_fleet_rows_equal_solo_rows_and_replay_across_packages(world,
                                                               tmp_path):
    """Two port workers drain the JAX trainer's checkpoints (2 tasks each):
    every row's metrics equal a solo port validator's exactly, the rows
    carry both workers' ids, and both packages' replay_ledger give the
    same control decisions, byte for byte."""
    ds, root = world["ds"], str(world["ckpts"])
    ledger_path = str(tmp_path / "fleet.jsonl")
    suite = _two_task_suite(ds)
    workers = [ValidatorWorker(
        root, _two_task_suite(ds),
        ledger=ValidationLedger(ledger_path, expected_tasks=("a", "b")),
        queue=WorkQueue(ledger_path, wid, capabilities={"mesh_size": 1}),
        worker_id=wid) for wid in ("w0", "w1")]
    for step in world["steps"]:
        workers[0].queue.publish(suite.plan_units(step))
    for _ in range(40):
        if not sum(w.run_once() for w in workers) \
                and not workers[0].queue.refresh().claimable({}):
            break
    fleet_rows = ValidationLedger(ledger_path).rows()
    assert {r["worker_id"] for r in fleet_rows} == {"w0", "w1"}
    solo = AsyncValidator(root, suite, ledger_path=str(tmp_path /
                                                       "solo.jsonl"))
    solo.validate_all_existing()
    solo_rows = {(r["step"], r["task"]): r for r in solo.ledger.rows()}
    assert len(fleet_rows) == len(solo_rows) == 2 * len(world["steps"])
    for r in fleet_rows:
        want = solo_rows[(r["step"], r["task"])]
        assert r["metrics"] == want["metrics"]
        assert "worker_id" not in want
    ccfg = dict(metric="0.5*a:MRR@10 + 0.5*b:MRR@10", keep_top_k=2,
                early_stop=True, patience=1, min_delta=0.5)
    port = replay_ledger(fleet_rows, ControlConfig(**ccfg),
                         expected_tasks=("a", "b"), group="completion")
    ref = jcontrol.replay_ledger(fleet_rows, jcontrol.ControlConfig(**ccfg),
                                 expected_tasks=("a", "b"),
                                 group="completion")
    got = [e.to_json() for e in port.events.decisions()]
    assert got and got == [e.to_json() for e in ref.events.decisions()]
    assert replay(ledger_path).events == jwq.replay(ledger_path).events


def test_cli_worker_mesh_size_under_cpu_and_flags(world, tmp_path,
                                                  monkeypatch, capsys):
    """``--worker --device cpu`` takes mesh_size 1 whatever the CUDA count
    (JAX's CPU device count without forced devices); the fleet flags reach
    the queue; a drained backlog exits 0."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    out = tmp_path / "out"
    rc = cli.main(_worker_argv(world, out, ["--worker_id", "solo-w",
                                            "--lease_ttl", "5",
                                            "--max_abandons", "1",
                                            "--capabilities", "kind=cpu"])
                  [3:])
    assert rc == 0
    err = capsys.readouterr().err
    assert "caps={'kind': 'cpu', 'mesh_size': 1}" in err
    led = ValidationLedger(str(out / "t_ledger.jsonl"))
    assert len(led.validated_steps) == len(world["steps"])
    assert {r["worker_id"] for r in led.rows()} == {"solo-w"}
    state = replay(str(out / "t_ledger.jsonl"), lease_ttl=5,
                   max_abandons=1)
    assert len(state.completed_units()) == len(world["steps"])


def _worker_argv(world, outdir, extra=()):
    return [sys.executable, "-m", "repro_torch.core.cli",
            "--query_file", str(world["queries"]),
            "--candidate_dir", str(world["corpus_dir"]),
            "--ckpts_dir", str(world["ckpts"]),
            "--qrel_file", str(world["qrels"]),
            "--q_max_len", "10", "--p_max_len", "26",
            "--run_name", "t", "--report_to", "jsonl",
            "--output_dir", str(outdir), "--device", "cpu",
            "--worker", "--lease_ttl", "8",
            "--encoder", "tests.test_torch_serve:toy_encoder_from_cli",
            *extra]


def _worker_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, ROOT] + env.get("PYTHONPATH", "").split(os.pathsep))
    return env


@pytest.mark.slow
def test_fleet_launcher_two_cli_workers_drain_backlog(world):
    """``python -m repro_torch.launch.fleet --workers 2 -- <cli --worker
    ...>``: two worker processes split the backlog through the shared
    ledger, the launcher reaps them and exits 0, and the ledger is
    complete, attributed and replayable."""
    outdir = world["base"] / "out_launcher"
    rc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fleet", "--workers", "2",
         "--poll_interval", "0.2", "--"] + _worker_argv(world, outdir),
        env=_worker_env(), cwd=ROOT, timeout=600).returncode
    assert rc == 0
    ledger_path = str(outdir / "t_ledger.jsonl")
    led = ValidationLedger(ledger_path)
    assert len(led.validated_steps) == len(world["steps"])
    assert all(r.get("worker_id", "").startswith("worker-")
               for r in led.rows())
    state = replay(ledger_path, lease_ttl=8)
    assert len(state.completed_units()) == len(world["steps"])
    assert len(state.units) == len(world["steps"])


def test_fleet_launcher_needs_a_worker_command():
    from repro_torch.launch import fleet
    with pytest.raises(SystemExit):
        fleet.main(["--workers", "2"])


@pytest.mark.slow
def test_fleet_survives_sigkilled_worker(world):
    """Two real workers; one is SIGKILLed once it holds a claim.  The
    survivor ticks the dead lease out, reclaims the unit, finishes the
    backlog and exits 0: nothing lost, no unit failed."""
    outdir = world["base"] / "out_kill"
    env = _worker_env()
    victim = subprocess.Popen(
        _worker_argv(world, outdir, ["--worker_id", "victim"]),
        env=env, cwd=ROOT)
    survivor = subprocess.Popen(
        _worker_argv(world, outdir, ["--worker_id", "survivor"]),
        env=env, cwd=ROOT)
    ledger_path = str(outdir / "t_ledger.jsonl")
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if os.path.exists(ledger_path) and any(
                    r.get("kind") == "claim" and r.get("worker") == "victim"
                    for r in read_jsonl_tolerant(ledger_path)[0]):
                break
            if victim.poll() is not None:
                break
            time.sleep(0.05)
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=30)
        assert survivor.wait(timeout=600) == 0
    finally:
        for p in (victim, survivor):
            if p.poll() is None:
                p.kill()
                p.wait()
    led = ValidationLedger(ledger_path)
    assert len(led.validated_steps) == len(world["steps"])
    state = replay(ledger_path, lease_ttl=8)
    assert len(state.completed_units()) == len(world["steps"])
    assert not [st for st in state.units.values() if st.status == "failed"]
    assert "survivor" in {r.get("worker_id") for r in led.rows()}
