"""The port's serving tier (``repro_torch.serve``): hot-swap races,
promotion failures, admission, swap events, the entry points.

Mirrors the 15 cases of tests/test_serve.py on the port, in the
reference's oracle style: every (step, query) answer is precomputed
offline, and every racing response must equal, bit for bit, the answer of
the step it names.  The checkpoints are the JAX package's: its
``train_toy_dr`` trains the toy retriever from a seed and its
``ckpt.save`` writes them; the port restores them by key path.  Across
the packages: the port's precomputed answers against the JAX
``QueryService``'s on the same checkpoints (allclose 1e-5, the same top-k
id sets), swap logs that replay through both packages' ``replay_swaps``
to one timeline, and the port validator's ``extra_protect`` keeping the
live step from GC.  Everything runs on the CPU (``device="cpu"``).
"""

import json
import os
import shutil
import threading
import time

import jax
import numpy as np
import pytest
import torch

from benchmarks.common import toy_spec as jtoy_spec
from benchmarks.common import train_toy_dr as jtrain_toy_dr
import repro.serve as jserve
from repro.ckpt import checkpoint as jckpt
from repro.data import corpus as jcorpus
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.control.events import (ACTUATION_KINDS, DECISION_KINDS,
                                        ControlEventLog)
from repro_torch.core import pytree
from repro_torch.data import corpus as corpus_lib
from repro_torch.models.toy import toy_spec
from repro_torch.serve import (AdmissionController, IndexBuilder, Promoter,
                               QueryService, ServeConfig, ServeOverloaded,
                               replay_swaps)

K = 8
#: port vs JAX answers on the same checkpoint: float32 sums in another order
CROSS_TOL = 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Corpus + 4 committed checkpoints (the JAX package's training and
    saves) + the expected port answer of every (step, query) pair,
    computed offline: the oracle the torn-index test checks every racing
    response against."""
    base = tmp_path_factory.mktemp("serve")
    ds = jcorpus.synthetic_retrieval_dataset(0, n_passages=180,
                                             n_queries=10)
    jspec = jtoy_spec(ds.vocab)
    _, snaps = jtrain_toy_dr(ds, jspec, steps=60, snapshot_every=20)
    ckdir = str(base / "ckpts")
    for step, params in snaps:
        jckpt.save(ckdir, step, {"params": params})
    spec = toy_spec(ds.vocab, device="cpu")
    builder = IndexBuilder(spec, ds.corpus, ServeConfig(k=K, batch_size=32))
    expected = {}
    steps = [s for s, _ in snaps]
    for step in steps:
        params = ckpt.restore(ckdir, step,
                              template={"params": spec.param_shapes}
                              )[0]["params"]
        index = builder.build(params, step)
        svc = QueryService(spec, k=K, max_batch=4)
        svc.install(index)
        for r in svc.answer([(q, ds.queries[q]) for q in ds.queries]):
            expected[(step, r.qid)] = (r.doc_ids, r.scores)
    return {"base": base, "ds": ds, "spec": spec, "jspec": jspec,
            "snaps": snaps, "ckdir": ckdir, "steps": steps,
            "expected": expected}


def _stack(world, tmp, *, target_fn=None, events=None, **prom_kw):
    ds, spec = world["ds"], world["spec"]
    builder = IndexBuilder(spec, ds.corpus, ServeConfig(k=K, batch_size=32))
    service = QueryService(spec, k=K, max_batch=4, flush_ms=2.0)
    promoter = Promoter(builder, service, world["ckdir"],
                        target_fn=target_fn, control_events=events,
                        log=str(tmp / "serve_events.jsonl"), **prom_kw)
    return builder, service, promoter


def _restore(world, step):
    return ckpt.restore(world["ckdir"], step,
                        template={"params": world["spec"].param_shapes}
                        )[0]["params"]


def test_expected_answers_match_jax_query_service(world):
    """The oracle itself, against the reference: the JAX package's
    ``QueryService`` on the same checkpoints answers the same top-k ids
    (as sets: float32 sums in another order may swap a near tie), scores
    within 1e-5."""
    ds, jspec = world["ds"], world["jspec"]
    jbuilder = jserve.IndexBuilder(jspec, ds.corpus,
                                   jserve.ServeConfig(k=K, batch_size=32))
    for step, params in world["snaps"]:
        svc = jserve.QueryService(jspec, k=K, max_batch=4)
        svc.install(jbuilder.build(params, step))
        for r in svc.answer([(q, ds.queries[q]) for q in ds.queries]):
            ids, scores = world["expected"][(step, r.qid)]
            assert set(ids) == set(r.doc_ids), (step, r.qid)
            np.testing.assert_allclose(scores, r.scores, rtol=CROSS_TOL,
                                       atol=CROSS_TOL)


# ---------------------------------------------------------------------------
# Hot-swap races
# ---------------------------------------------------------------------------

def test_no_torn_index_under_concurrent_promotions(world, tmp_path):
    """Queries hammered across repeated promotions: every response must
    equal the offline answer of exactly the step it attributes — a torn
    read (old corpus embeddings + new params, or a half-installed
    pointer) would produce an answer matching no single checkpoint."""
    ds = world["ds"]
    target = {"step": world["steps"][0]}
    _, service, promoter = _stack(world, tmp_path,
                                  target_fn=lambda: target["step"])
    assert promoter.poll_once()
    service.start()
    stop = threading.Event()
    failures = []
    served_steps = set()

    def client(i):
        qids = list(ds.queries)
        j = 0
        while not stop.is_set():
            qid = qids[(i + j) % len(qids)]
            j += 1
            try:
                r = service.submit(qid, ds.queries[qid], timeout=30)
            except Exception as e:         # a dropped query IS a blackout
                failures.append(("exc", qid, repr(e)))
                return
            served_steps.add(r.step)
            want = world["expected"][(r.step, r.qid)]
            if (r.doc_ids, r.scores) != want:
                failures.append((r.step, r.qid))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    try:
        # >= 3 promotions under sustained load, cycling through checkpoints
        flips = world["steps"][1:] + world["steps"][:1]
        for s in flips:
            time.sleep(0.05)
            target["step"] = s
            assert promoter.poll_once(), f"promotion to {s} failed"
    finally:
        stop.set()
        for t in threads:
            t.join(60)
        service.stop()
    assert not any(t.is_alive() for t in threads)
    assert not failures, f"torn responses: {failures[:5]}"
    assert len(promoter.swaps) >= 3
    assert service.served > 0
    assert served_steps <= set(world["steps"])


def test_failed_build_leaves_old_index_serving(world, tmp_path):
    """Two-phase discipline: a promotion dying mid-build must not touch
    the live pointer, and must leave an auditable swap_failed event."""
    ds = world["ds"]
    s1, s2 = world["steps"][:2]
    target = {"step": s1}

    def hook(step):
        if step == s2:
            raise RuntimeError("mid-build device loss")

    builder, service, promoter = _stack(world, tmp_path,
                                        target_fn=lambda: target["step"],
                                        build_hook=hook)
    assert promoter.poll_once() and service.live_step() == s1
    target["step"] = s2
    assert not promoter.poll_once()
    assert service.live_step() == s1          # old index still serving
    qid = next(iter(ds.queries))
    r = service.answer([(qid, ds.queries[qid])])[0]
    assert r.step == s1
    assert (r.doc_ids, r.scores) == world["expected"][(s1, r.qid)]
    (step, err), = promoter.failures
    assert step == s2 and "mid-build" in str(err)
    fail_ev = [e for e in promoter.log.events() if e.kind == "swap_failed"]
    assert len(fail_ev) == 1 and fail_ev[0].step == s2
    assert fail_ev[0].payload["live_step"] == s1
    # the failure is transient: clearing it lets the next poll promote
    promoter.build_hook = None
    assert promoter.poll_once() and service.live_step() == s2


def test_verify_rejects_nonfinite_index(world, tmp_path):
    """Phase-two verify catches a checkpoint that encodes garbage (NaN
    embeddings) before the flip."""
    s1, s2 = world["steps"][:2]
    target = {"step": s1}
    _, service, promoter = _stack(world, tmp_path,
                                  target_fn=lambda: target["step"])
    assert promoter.poll_once() and service.live_step() == s1
    poisoned = pytree.tree_map(lambda x: x * float("nan"),
                               {"params": _restore(world, s2)})
    promoter.params_extractor = lambda state: poisoned["params"]
    target["step"] = s2
    assert not promoter.poll_once()
    assert service.live_step() == s1
    assert "non-finite" in str(promoter.failures[-1][1])


def test_stacked_selects_coalesce(world, tmp_path):
    """N select events between polls collapse into one swap to the newest
    winner — intermediate checkpoints are never built."""
    s1, s2, s3 = world["steps"][:3]
    events = str(tmp_path / "control.jsonl")
    log = ControlEventLog(events)
    builder, service, promoter = _stack(world, tmp_path, events=events)
    log.emit("select", s1, best_step=s1)
    assert promoter.poll_once() and service.live_step() == s1
    builds_before = builder.index_builds
    log.emit("select", s2, best_step=s2)
    log.emit("select", s3, best_step=s3)
    assert promoter.poll_once()
    assert service.live_step() == s3
    assert builder.index_builds == builds_before + 1   # s2 never built
    assert not promoter.poll_once()                    # idempotent at rest


def test_select_during_inflight_swap_coalesces(world, tmp_path):
    """A select landing during a build neither deadlocks nor gets lost:
    the in-flight swap completes, the next poll promotes the newer
    winner."""
    s1, s2, s3 = world["steps"][:3]
    events = str(tmp_path / "control.jsonl")
    log = ControlEventLog(events)

    def hook(step):
        if step == s2:                 # mid-build of s2, s3 gets selected
            log.emit("select", s3, best_step=s3)

    _, service, promoter = _stack(world, tmp_path, events=events,
                                  build_hook=hook)
    log.emit("select", s1, best_step=s1)
    assert promoter.poll_once()
    log.emit("select", s2, best_step=s2)
    assert promoter.poll_once() and service.live_step() == s2
    assert promoter.poll_once() and service.live_step() == s3
    assert [w for _, w in promoter.swaps] == [s1, s2, s3]


def test_uncommitted_selection_waits(world, tmp_path):
    """A selected-but-not-yet-durable checkpoint is not promoted (no
    failure either) — the promoter waits for the two-phase commit."""
    target = {"step": 999}
    _, service, promoter = _stack(world, tmp_path,
                                  target_fn=lambda: target["step"])
    assert not promoter.poll_once()
    assert promoter.failures == [] and service.live_step() is None


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------

def test_admission_rejects_past_bound(world, tmp_path):
    """Beyond max_pending in-flight requests, submits fail fast with
    ServeOverloaded instead of queueing unboundedly; capacity frees once
    the batcher drains."""
    ds, spec = world["ds"], world["spec"]
    builder = IndexBuilder(spec, ds.corpus, ServeConfig(k=K, batch_size=32))
    adm = AdmissionController(max_pending=1)
    service = QueryService(spec, k=K, max_batch=4, flush_ms=2.0,
                           admission=adm)
    service.install(builder.build(_restore(world, world["steps"][0]),
                                  world["steps"][0]))
    qid = next(iter(ds.queries))
    # service not started: the first submit occupies the one slot
    blocker = threading.Thread(
        target=lambda: pytest.raises(TimeoutError, service.submit, qid,
                                     ds.queries[qid], timeout=0.7))
    blocker.start()
    time.sleep(0.1)
    with pytest.raises(ServeOverloaded):
        service.submit(qid, ds.queries[qid], timeout=1.0)
    blocker.join(10)
    assert not blocker.is_alive()
    assert adm.rejected == 1 and adm.peak == 1
    # slot released after the blocked request timed out
    service.start()
    try:
        r = service.submit(qid, ds.queries[qid], timeout=30)
        assert r.step == world["steps"][0]
    finally:
        service.stop()
    assert adm.pending == 0


@pytest.mark.parametrize("side", ["port", "ref"])
def test_admission_controller_counters(side):
    cls = AdmissionController if side == "port" \
        else jserve.AdmissionController
    adm = cls(max_pending=2)
    assert adm.try_acquire() and adm.try_acquire()
    assert not adm.try_acquire()
    adm.release()
    assert adm.try_acquire()
    assert adm.admitted == 3 and adm.rejected == 1 and adm.peak == 2
    with pytest.raises(ValueError):
        cls(max_pending=0)


def test_admission_binds_port_metrics():
    """Rejections before and after the bind land in the port registry's
    ``serve.admission_rejects`` counter."""
    from repro_torch.obs import MetricsRegistry
    adm = AdmissionController(max_pending=1)
    assert adm.try_acquire() and not adm.try_acquire()
    reg = MetricsRegistry()
    adm.bind_metrics(reg)
    assert not adm.try_acquire()
    assert reg.counter("serve.admission_rejects").value == 2


# ---------------------------------------------------------------------------
# Swap events: provenance + replay
# ---------------------------------------------------------------------------

def test_swap_events_carry_provenance_and_replay(world, tmp_path):
    """Every swap is an actuation event with full provenance, and the
    live-step timeline is re-derivable offline from the log alone — by
    either package's ``replay_swaps``."""
    ds = world["ds"]
    s1, s2 = world["steps"][:2]
    target = {"step": s1}
    _, service, promoter = _stack(world, tmp_path,
                                  target_fn=lambda: target["step"])
    assert promoter.poll_once()
    target["step"] = s2
    assert promoter.poll_once()
    evs = [e for e in promoter.log.events() if e.kind == "swap"]
    assert [e.step for e in evs] == [s1, s2]
    for e in evs:
        assert e.payload["engine"] == "serve"
        assert e.payload["score_dtype"] == "f32"
        assert e.payload["impl"] == "torch"
        assert e.payload["n_docs"] == len(ds.corpus)
        assert type(e.payload["n_docs"]) is int
        assert type(e.payload["build_s"]) is float
        assert e.payload["build_s"] >= 0
    assert evs[0].payload["prev_step"] == -1
    assert evs[1].payload["prev_step"] == s1
    path = str(tmp_path / "serve_events.jsonl")
    timeline = replay_swaps(path)
    assert [(t["prev_step"], t["step"]) for t in timeline] == \
        [(-1, s1), (s1, s2)]
    assert jserve.replay_swaps(path) == timeline
    # swaps are actuations: excluded from decision replay comparison
    assert {"swap", "swap_failed"} <= ACTUATION_KINDS
    assert not ({"swap", "swap_failed"} & DECISION_KINDS)
    assert promoter.log.decisions() == []


def test_reference_swap_log_replays_in_port(world, tmp_path):
    """The reverse: a log the JAX package's promoter writes (real swaps
    and a failed one) replays through the port's ``replay_swaps`` to the
    reference's timeline, and the port's log reader loads every event."""
    ds, jspec = world["ds"], world["jspec"]
    s1, s2, s3 = world["steps"][:3]
    target = {"step": s1}

    def hook(step):
        if step == s2:
            raise RuntimeError("injected")

    path = str(tmp_path / "ref_events.jsonl")
    jp = jserve.Promoter(
        jserve.IndexBuilder(jspec, ds.corpus,
                            jserve.ServeConfig(k=K, batch_size=32)),
        jserve.QueryService(jspec, k=K, max_batch=4), world["ckdir"],
        target_fn=lambda: target["step"], log=path, build_hook=hook)
    assert jp.poll_once()
    target["step"] = s2
    assert not jp.poll_once()
    target["step"] = s3
    assert jp.poll_once()
    want = jserve.replay_swaps(path)
    assert [(t["prev_step"], t["step"]) for t in want] == \
        [(-1, s1), (s1, s3)]
    assert replay_swaps(path) == want
    port_log = ControlEventLog(path)
    assert [e.kind for e in port_log.events()] == \
        ["swap", "swap_failed", "swap"]
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    assert [e.to_json() for e in port_log.events()] == lines


def test_background_promoter_loop(world, tmp_path):
    """The threaded promoter: select events flow to live swaps without any
    explicit polling by the caller."""
    s1, s2 = world["steps"][:2]
    events = str(tmp_path / "control.jsonl")
    log = ControlEventLog(events)
    _, service, promoter = _stack(world, tmp_path, events=events,
                                  poll_interval_s=0.02)
    promoter.start()
    try:
        log.emit("select", s1, best_step=s1)
        deadline = time.time() + 30
        while service.live_step() != s1 and time.time() < deadline:
            time.sleep(0.02)
        assert service.live_step() == s1
        log.emit("select", s2, best_step=s2)
        while service.live_step() != s2 and time.time() < deadline:
            time.sleep(0.02)
        assert service.live_step() == s2
    finally:
        promoter.stop()


# ---------------------------------------------------------------------------
# Index build economics + GC contract
# ---------------------------------------------------------------------------

def test_token_store_built_once_across_builds(world):
    """The corpus TokenStore (the checkpoint-independent half of an index
    build) is padded once at construction and shared by every promoted
    checkpoint — only the encode pass reruns."""
    ds, spec = world["ds"], world["spec"]
    builder = IndexBuilder(spec, ds.corpus, ServeConfig(k=K, batch_size=32))
    store = builder.store
    p1 = _restore(world, world["steps"][0])
    p2 = _restore(world, world["steps"][1])
    i1, i2 = builder.build(p1, 1), builder.build(p2, 2)
    assert builder.store is store and builder.index_builds == 2
    assert i1.doc_ids is builder.doc_ids and i2.doc_ids is builder.doc_ids
    assert i1.n_docs == i2.n_docs == len(ds.corpus)


def test_promoter_protect_set(world, tmp_path):
    """The GC contract: live + in-flight-promotion steps are protected;
    nothing is protected before the first install."""
    s1, s2 = world["steps"][:2]
    target = {"step": s1}
    seen = {}

    def hook(step):
        # snapshot during the build: both old-live and promoting protected
        seen["mid"] = promoter.protect_set()

    _, service, promoter = _stack(world, tmp_path,
                                  target_fn=lambda: target["step"],
                                  build_hook=hook)
    assert promoter.protect_set() == set()
    assert promoter.poll_once()
    assert promoter.protect_set() == {s1}
    target["step"] = s2
    assert promoter.poll_once()
    assert seen["mid"] == {s1, s2}
    assert promoter.protect_set() == {s2}


def test_validator_extra_protect_keeps_live_step(world, tmp_path):
    """The port validator's ``extra_protect`` hook: once every step is
    validated, GC by the validator's ``protect_set`` deletes the others but
    never the step the live index was built from."""
    from repro_torch.core.suite import (ValidationConfig, ValidationSuite,
                                        ValidationTask)
    from repro_torch.core.validator import AsyncValidator
    ds, spec = world["ds"], world["spec"]
    ckdir = str(tmp_path / "ckpts")
    shutil.copytree(world["ckdir"], ckdir)
    live = world["steps"][1]
    builder = IndexBuilder(spec, ds.corpus, ServeConfig(k=K, batch_size=32))
    service = QueryService(spec, k=K, max_batch=4)
    promoter = Promoter(builder, service, ckdir, target_fn=lambda: live,
                        log=str(tmp_path / "serve.jsonl"))
    assert promoter.poll_once()
    suite = ValidationSuite(spec, [ValidationTask(
        "default", ds.corpus, ds.queries, ds.qrels)],
        ValidationConfig(metrics=("MRR@10",), k=K, batch_size=32))
    plain = AsyncValidator(ckdir, suite)
    hooked = AsyncValidator(ckdir, suite,
                            extra_protect=promoter.protect_set)
    for v in (plain, hooked):
        v.validate_all_existing()
        assert not v.errors
    assert plain.protect_set() == set()
    assert hooked.protect_set() == {live}
    keep = world["steps"][-1]
    deleted = ckpt.gc_checkpoints(ckdir, keep=[keep],
                                  protect=hooked.protect_set())
    assert sorted(deleted) == sorted(set(world["steps"]) - {keep, live})
    assert ckpt.list_steps(ckdir) == sorted({keep, live})


# ---------------------------------------------------------------------------
# launch/serve.py: retrieval entry point + LM-demo compatibility
# ---------------------------------------------------------------------------

def toy_encoder_from_cli(args):
    """--encoder hook for the launch CLI test."""
    return toy_spec(503, device=args.device)


def _write_files(world, tmp_path, qrels=False):
    ds = world["ds"]
    cdir = tmp_path / "corpus"
    cdir.mkdir()
    corpus_lib.write_jsonl(str(cdir / "c.jsonl"), ds.corpus)
    qfile = tmp_path / "q.jsonl"
    corpus_lib.write_jsonl(str(qfile), ds.queries)
    qrels_path = tmp_path / "qrels.txt"
    with open(qrels_path, "w") as f:
        for qid, docs in ds.qrels.items():
            for did, g in docs.items():
                f.write(f"{qid} 0 {did} {g}\n")
    return str(cdir), str(qfile), str(qrels_path)


def test_launch_serve_is_retrieval_cli(world, tmp_path, capsys):
    """launch/serve.py serves retrieval queries end to end on the CPU:
    promote the latest committed checkpoint, answer the query file, report
    latency percentiles; its answers are the precomputed ones."""
    from repro_torch.launch.serve import main
    cdir, qfile, _ = _write_files(world, tmp_path)
    ckdir = str(tmp_path / "ckpts")
    shutil.copytree(world["ckdir"], ckdir)
    rc = main(["--candidate_dir", cdir, "--query_file", qfile,
               "--ckpts_dir", ckdir, "--k", "5", "--max_batch", "4",
               "--batch_size", "32", "--device", "cpu",
               "--encoder", "tests.test_torch_serve:toy_encoder_from_cli"])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"step={world['steps'][-1]}" in out and "p99=" in out
    assert replay_swaps(os.path.join(ckdir, "serve_events.jsonl")) == \
        [{"seq": 0, "step": world["steps"][-1], "prev_step": -1}]


def test_launch_serve_cli_docs_are_retrieval():
    """launch/serve is the retrieval entry point, and the LM demo's
    ``serve_batch`` is re-exported from it, as in the reference."""
    import repro_torch.launch.lm_demo as lm_demo
    import repro_torch.launch.serve as serve
    assert "retrieval" in (serve.__doc__ or "").lower()
    assert "--arch qwen2" not in (serve.__doc__ or "")
    assert serve.serve_batch is lm_demo.serve_batch   # compat re-export
    assert callable(lm_demo.serve_batch)


def test_core_cli_serve_one_shot(world, tmp_path, capsys):
    """``--serve`` on the port's CLI: validation and serving in one
    process — the control plane picks the best checkpoint, the promoter
    promotes exactly that pick, the one-shot serve pass answers the query
    file attributing it, and GC (``--keep_top_k 1``) keeps the served
    step.  Swap provenance lands in <run>_serve.jsonl, which both
    packages replay alike."""
    from repro_torch.core.cli import main
    ds = world["ds"]
    cdir, qfile, qrels = _write_files(world, tmp_path)
    ckdir = str(tmp_path / "ckpts")
    shutil.copytree(world["ckdir"], ckdir)
    outdir = tmp_path / "out"
    rc = main(["--query_file", qfile, "--candidate_dir", cdir,
               "--ckpts_dir", ckdir, "--qrel_file", str(qrels),
               "--metrics", "MRR@10", "--keep_top_k", "1",
               "--run_name", "t", "--output_dir", str(outdir),
               "--device", "cpu", "--batch_size", "32",
               "--serve", "--serve_k", "5", "--serve_batch", "4",
               "--encoder", "tests.test_torch_serve:toy_encoder_from_cli"])
    assert rc == 0
    out = capsys.readouterr().out
    path = str(outdir / "t_serve.jsonl")
    swaps = replay_swaps(path)
    assert swaps == jserve.replay_swaps(path)
    assert len(swaps) == 1               # one-shot: exactly one promotion
    best = swaps[0]["step"]
    assert best in world["steps"]
    assert f"[serve] answered {len(ds.queries)} queries" in out
    assert f"step={best}" in out         # responses attribute the pick
    rows = [json.loads(line) for line in open(outdir / "t_ledger.jsonl")]
    mrr = {r["step"]: r["metrics"]["MRR@10"] for r in rows}
    assert mrr[best] == max(mrr.values())
    assert best in ckpt.list_steps(ckdir)


@pytest.mark.parametrize("entry", ["core.cli", "launch.serve"])
def test_serve_entry_points_raise_without_a_card(world, tmp_path,
                                                 monkeypatch, entry):
    """Without ``--device cpu`` the serving entry points run on ``cuda``,
    and raise when no card is visible instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cdir, qfile, qrels = _write_files(world, tmp_path)
    common = ["--query_file", qfile, "--candidate_dir", cdir,
              "--ckpts_dir", world["ckdir"],
              "--encoder", "tests.test_torch_serve:toy_encoder_from_cli"]
    if entry == "core.cli":
        from repro_torch.core.cli import main
        argv = common + ["--qrel_file", qrels, "--serve",
                         "--output_dir", str(tmp_path / "out")]
    else:
        from repro_torch.launch.serve import main
        argv = common
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv)


def test_serve_flags_are_ported(world, tmp_path):
    """The six ``--serve*`` flags parse with the reference's defaults, and
    the not-yet-ported table is gone: ``--scan_window 4`` parses and
    validates to the ledger row of the default window."""
    from repro_torch.core import cli
    assert not hasattr(cli, "_NOT_PORTED")
    args = cli._parser().parse_args(
        ["--query_file", "q", "--candidate_dir", "c", "--ckpts_dir", "k",
         "--qrel_file", "r"])
    assert (args.serve, args.serve_k, args.serve_batch, args.serve_flush_ms,
            args.serve_pending, args.serve_events, args.scan_window) == \
        (False, 10, 8, 4.0, 256, None, 8)
    cdir, qfile, qrels = _write_files(world, tmp_path)
    rows = {}
    for window in ("8", "4"):
        out = tmp_path / f"w{window}"
        assert cli.main(["--query_file", qfile, "--candidate_dir", cdir,
                         "--ckpts_dir", world["ckdir"], "--qrel_file", qrels,
                         "--output_dir", str(out), "--device", "cpu",
                         "--batch_size", "32", "--scan_window", window,
                         "--metrics", "MRR@10", "Recall@20", "--encoder",
                         "tests.test_torch_serve:toy_encoder_from_cli"]) == 0
        rows[window] = [json.loads(line) for line in
                        open(out / "asyncval_ledger.jsonl")]
    assert [r["step"] for r in rows["4"]] == world["steps"]
    for got, want in zip(rows["4"], rows["8"]):
        assert got["metrics"] == want["metrics"]
        assert got["subset_size"] == want["subset_size"]


def test_port_restores_the_reference_checkpoints(world):
    """The world's checkpoints are the JAX package's; the port read them
    into CPU torch tensors."""
    params = _restore(world, world["steps"][0])
    assert isinstance(params["table"], torch.Tensor)
    np.testing.assert_array_equal(
        params["table"].numpy(),
        np.asarray(jax.device_get(world["snaps"][0][1]["table"])))
