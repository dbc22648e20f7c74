"""End-to-end convergence control on the port: trainer + async validator +
control plane, against the reference's replay.

Mirrors tests/test_control_integration.py on the CPU with a toy torch
encoder: the plateau detector publishes the STOP marker from the validator
thread and the port's trainer halts early; quality-aware GC leaves exactly
top-k ∪ protected; the greedy soup's virtual checkpoint re-validates at
least as well as the best single one; offline replay reproduces every
decision.  Across packages: ``repro.control.replay_ledger`` and
``repro_torch.control.replay_ledger`` fed the same ledger give
byte-identical decision JSON, and the port's online decisions equal the
reference's replay of the port's ledger.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import repro.control as jc
import repro_torch.control as tc
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.control.ensemble import VIRTUAL_KEY
from repro_torch.core.samplers import RunFileTopK
from repro_torch.core.suite import (ValidationConfig, ValidationSuite,
                                    ValidationTask)
from repro_torch.core.validator import AsyncValidator
from repro_torch.data import corpus as synthetic_ds
from repro_torch.models.biencoder import EncoderSpec
from repro_torch.train import optim
from repro_torch.train.trainer import Trainer, TrainerConfig

DIM, VOCAB = 16, 211


def _toy_encode(params, tokens, mask):
    emb = params["table"][tokens.long()]
    m = mask.to(emb.dtype)[..., None]
    v = (emb * m).sum(1) / torch.clamp(m.sum(1), min=1e-6)
    return v / torch.clamp(v.norm(dim=-1, keepdim=True), min=1e-6)


def _table(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((VOCAB, DIM)).astype(np.float32)


def toy_spec():
    return EncoderSpec(name="toy", dim=DIM, encode_query=_toy_encode,
                       encode_passage=_toy_encode,
                       init=lambda seed: {"table": _table(seed)},
                       param_shapes={"table": (VOCAB, DIM)},
                       device=torch.device("cpu"), q_max_len=10,
                       p_max_len=26)


def _suite(seed, n_passages, n_queries, k, base_k):
    ds = synthetic_ds.synthetic_retrieval_dataset(
        seed, n_passages=n_passages, n_queries=n_queries, vocab=VOCAB)
    baseline = synthetic_ds.lexical_baseline_run(ds, k=base_k)
    return ValidationSuite(toy_spec(), [ValidationTask(
        "default", ds.corpus, ds.queries, ds.qrels,
        sampler=RunFileTopK(depth=5), baseline_run=baseline)],
        ValidationConfig(metrics=("MRR@10",), k=k, batch_size=32))


def _quadratic_trainer(root, stop_path, target, *, total, async_save=True):
    """AdamW driving the table to ``target``: the loss goes to 0 while the
    ranking (and so MRR@10) freezes, a plateau by construction."""
    target = torch.from_numpy(target)

    def loss_fn(params, batch):
        d = params["table"] - target
        return torch.mean(d * d), {}

    def batch_iter(step):
        if async_save:
            time.sleep(0.004)   # a per-step cost, so checkpoints outpace
        return {}               # validation without racing the test

    tcfg = TrainerConfig(total_steps=total, ckpt_every=20, log_every=20,
                         ckpt_dir=root, stop_file=stop_path,
                         async_save=async_save)
    return Trainer(tcfg, loss_fn, optim.adamw(0.1, weight_decay=0.0),
                   {"table": torch.from_numpy(_table(0))}, batch_iter)


def _decisions_json(plane):
    return [e.to_json() for e in plane.events.decisions()]


def test_control_plane_end_to_end(tmp_path):
    workdir = str(tmp_path)
    root = os.path.join(workdir, "ck")
    stop_path = os.path.join(workdir, "STOP")
    suite = _suite(0, 120, 16, 20, 30)
    cfg = tc.ControlConfig(metric="MRR@10", early_stop=True, patience=3,
                           min_delta=1e-6, keep_top_k=2, ensemble_top_k=2)
    plane = tc.ControlPlane(root, cfg, stop_path=stop_path,
                            event_path=os.path.join(workdir, "control.jsonl"))
    validator = AsyncValidator(
        root, suite, controller=plane, poll_interval_s=0.01,
        ledger_path=os.path.join(workdir, "ledger.jsonl"))
    total_budget = 3000
    trainer = _quadratic_trainer(root, stop_path, _table(7),
                                 total=total_budget)
    train_history = []

    def on_metrics(step, m):
        train_history.append((step, m["loss"]))
        plane.note_train(step, m)

    validator.start()
    t0 = time.time()
    trainer.run(on_metrics=on_metrics)
    train_wall = time.time() - t0
    validator.stop(drain=True)
    assert not validator.errors

    # asynchronous early stop
    assert trainer.stopped_early and trainer.step < total_budget
    verdict = tc.stop_requested(stop_path)
    assert verdict is not None and verdict["reason"] == "plateau"
    assert trainer.stop_verdict["reason"] == "plateau"
    assert train_wall < 4.0 * (trainer.step * 0.004 + 2.0)

    # quality-aware GC: exactly top-k ∪ protected (nothing is unvalidated
    # after the drain)
    expected_keep = plane.selector.keep_set(protect=validator.protect_set(),
                                            k=2)
    assert set(ckpt.list_steps(root)) == expected_keep
    assert len(expected_keep) == 2

    # the soup scores at least the best single, through the normal path
    best_single = plane.selector.best_value
    vstep = plane.build_ensemble(
        lambda p: suite.validate_params(p).metrics["MRR@10"],
        template=validator.worker.template)
    assert vstep is not None
    _, extra = ckpt.restore(root, vstep, template=validator.worker.template)
    assert extra[VIRTUAL_KEY] == plane.ensemble_members
    assert validator.validate_pending() == 1   # the watcher finds the soup
    soup_row = validator.ledger.rows()[-1]
    assert soup_row["step"] == vstep
    assert soup_row["metrics"]["MRR@10"] >= best_single - 1e-12

    # offline replay reproduces every decision, in both packages, byte for
    # byte, from the port's ledger
    rows = validator.ledger.rows()
    for pkg in (tc, jc):
        offline = pkg.replay_ledger(rows, pkg.ControlConfig(
            metric="MRR@10", early_stop=True, patience=3, min_delta=1e-6,
            keep_top_k=2, ensemble_top_k=2), train_history=train_history)
        assert _decisions_json(offline) == _decisions_json(plane)
        assert offline.stopped and offline.earlystop.reason == "plateau"
        assert offline.selector.top_steps() == plane.selector.top_steps()
    with open(os.path.join(workdir, "control.jsonl")) as f:
        kinds = [json.loads(line)["kind"] for line in f if line.strip()]
    assert "stop" in kinds and "gc" in kinds and "ensemble" in kinds
    # the persisted log reloads to the same decisions in both packages
    for pkg in (tc, jc):
        log = pkg.ControlEventLog(os.path.join(workdir, "control.jsonl"))
        assert [e.to_json() for e in log.decisions()] == \
            _decisions_json(plane)


def _ledger_rows(seed, n_steps, *, two_tasks=False, handoff_every=0):
    """A synthetic ledger: noisy, slowly saturating MRR@10 per step, with
    provenance keys as the validators write them."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(1, n_steps + 1):
        base = 0.6 * (1.0 - np.exp(-i / 4.0))
        for task in (("default", "heldout") if two_tasks else ("default",)):
            row = {"step": 10 * i, "task": task,
                   "metrics": {"MRR@10": float(base + rng.normal() * 0.02),
                               "Recall@100": float(rng.uniform())},
                   "timings": {"total_s": 0.1}, "subset_size": 50,
                   "engine": "streaming", "score_dtype": "f32"}
            if handoff_every and i % handoff_every == 0:
                row["handoff"] = "snapshot"
            rows.append(row)
    return rows


REPLAY_CASES = {
    "select_only": (dict(metric="MRR@10", keep_top_k=3), {}),
    "plateau_ema": (dict(metric="MRR@10", early_stop=True, patience=2,
                         min_delta=0.01, ema=0.5, keep_top_k=2),
                    {"handoff_every": 3}),
    "overfit": (dict(metric="MRR@10", early_stop=True, patience=50,
                     overfit_window=3, ensemble_top_k=3), {}),
    "composite_min": (dict(metric="-1*heldout:MRR@10 + 0.5*default:Recall@100",
                           mode="min", early_stop=True, patience=3),
                      {"two_tasks": True}),
}


@pytest.mark.parametrize("case", sorted(REPLAY_CASES))
def test_replay_ledger_byte_identical_across_packages(tmp_path, case):
    """Each package's ``replay_ledger``, fed the same ledger file, gives
    byte-identical decision JSON."""
    kw, rows_kw = REPLAY_CASES[case]
    path = str(tmp_path / "ledger.jsonl")
    with open(path, "w") as f:
        for row in _ledger_rows(5, 16, **rows_kw):
            f.write(json.dumps(row) + "\n")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    # the train-loss feed of the overfit detector: falling throughout
    history = [(5 * i, float(2.0 / (1 + i))) for i in range(40)]
    expected = ("default", "heldout") if rows_kw.get("two_tasks") else None
    out = {}
    for name, pkg in (("ref", jc), ("port", tc)):
        plane = pkg.replay_ledger(rows, pkg.ControlConfig(**kw),
                                  train_history=history,
                                  expected_tasks=expected)
        out[name] = (_decisions_json(plane), plane.stopped,
                     plane.selector.top_steps())
    assert out["port"] == out["ref"]
    assert out["port"][0]


def test_stale_stop_marker_cleared_on_new_run(tmp_path):
    """A STOP verdict belongs to one run: a restarted run in the same
    workdir clears it and trains."""
    from repro_torch.launch.train import run

    class Args:
        arch = "dr-bert-base"
        workdir = str(tmp_path / "run")
        steps = 8
        ckpt_every = 8
        batch_size = 8
        corpus_size = 80
        n_queries = 12
        q_max_len = 10
        p_max_len = 26
        depth = 10
        lr = 2e-3
        seed = 0
        subset = True
        sync = False
        full = False
        device = "cpu"
        early_stop_patience = 3            # control plane armed

    os.makedirs(Args.workdir, exist_ok=True)
    tc.write_stop_marker(os.path.join(Args.workdir, "STOP"),
                         {"reason": "plateau", "step": 999})
    res = run(Args())
    assert not res["stopped_early"]
    assert res["validated_steps"] == [8]


def test_sync_mode_control_plane_still_works(tmp_path):
    """Fig. 1a composes with the control plane: the same plateau stops the
    trainer through the same marker, inline."""
    workdir = str(tmp_path)
    root = os.path.join(workdir, "ck")
    stop_path = os.path.join(workdir, "STOP")
    suite = _suite(1, 80, 12, 10, 20)
    plane = tc.ControlPlane(root, tc.ControlConfig(
        metric="MRR@10", early_stop=True, patience=2, min_delta=1e-6),
        stop_path=stop_path)
    validator = AsyncValidator(root, suite, controller=plane)
    trainer = _quadratic_trainer(root, stop_path, _table(3), total=2000,
                                 async_save=False)

    def on_metrics(step, m):
        plane.note_train(step, m)
        validator.validate_pending()        # paper Fig. 1a: inline

    trainer.run(on_metrics=on_metrics)
    assert trainer.stopped_early and trainer.step < 2000
    assert plane.earlystop.reason == "plateau"


def test_launch_train_control_and_handoff(tmp_path):
    """``python -m repro_torch.launch.train`` with every control and
    hand-off flag on the CPU, in the inline mode (Fig. 1a, so the order of
    verdicts does not depend on thread timing): a deterministic plateau (no
    checkpoint can improve MRR@10 by 1.0) writes the STOP marker at the
    third verdict and the trainer halts at its next step, GC keeps the top
    two, the soup is committed and ledgered, snapshot-scored rows say so,
    and each package's replay of the ledger gives the online decisions."""
    from repro_torch.launch import train as tlaunch
    work = tmp_path / "w"
    res = tlaunch.main([
        "--device", "cpu", "--sync", "--workdir", str(work), "--steps", "25",
        "--ckpt-every", "5", "--corpus-size", "60", "--n-queries", "8",
        "--early-stop-patience", "2", "--early-stop-min-delta", "1.0",
        "--keep-top-k", "2", "--ensemble-top-k", "2", "--handoff",
        "--handoff-spool", str(tmp_path / "spool")])
    assert not res["errors"]
    assert res["stopped_early"] and res["stop_verdict"]["reason"] == \
        "plateau" and res["stop_verdict"]["step"] == 15
    with open(work / "ledger.jsonl") as f:
        rows = [json.loads(line) for line in f if line.strip()]
    steps = [r["step"] for r in rows]
    # inline: the checkpoint of step 5 is validated at step 10, ..., the
    # third verdict (step 15) at step 20, and the trainer stops before 21
    assert steps[:4] == [5, 10, 15, 20] and res["ensemble"] is not None
    assert steps[-1] == res["ensemble"]["step"]
    assert set(res["kept_checkpoints"]) <= set(steps)
    assert len(res["kept_checkpoints"]) == 2
    # snapshot-scored rows carry the key; the soup was restored from disk
    assert any(r.get("handoff") == "snapshot" for r in rows)
    assert "handoff" not in rows[-1]
    decisions = [e.to_json() for e in tc.ControlEventLog(
        str(work / "control.jsonl")).decisions()]
    for pkg in (tc, jc):
        replayed = pkg.replay_ledger(rows, pkg.ControlConfig(
            metric="MRR@10", early_stop=True, patience=2, min_delta=1.0,
            keep_top_k=2, ensemble_top_k=2))
        assert _decisions_json(replayed) == decisions
    # every snapshot was retired: validated and durable
    assert [n for n in os.listdir(tmp_path / "spool")
            if n.startswith("snap_")] == []


# ---------------------------------------------------------------------------
# The CLI's control and hand-off flags
# ---------------------------------------------------------------------------

CLI_STEPS = (10, 20, 30, 40)


@pytest.fixture(scope="module")
def cli_space(tmp_path_factory):
    """Corpus files and four checkpoints of the smoke dr-bert (the JAX
    package's init, as tests/test_torch_slice.py writes them)."""
    from repro.ckpt import checkpoint as jckpt
    from repro.configs import dr_bert_base as jcfg_mod
    from repro.data import corpus as jcorpus
    from repro.models import nn as jnn
    from repro.models import transformer as jtfm
    import jax
    base = tmp_path_factory.mktemp("cli_control")
    ds = jcorpus.synthetic_retrieval_dataset(0, n_passages=96, n_queries=12,
                                             vocab=211, p_len=20, q_len=6)
    (base / "corpus").mkdir()
    jcorpus.write_jsonl(str(base / "corpus" / "c.jsonl"), ds.corpus)
    jcorpus.write_jsonl(str(base / "q.jsonl"), ds.queries)
    with open(base / "qrels.txt", "w") as f:
        for qid, docs in ds.qrels.items():
            for did, g in docs.items():
                f.write(f"{qid} 0 {did} {g}\n")
    cfg = jcfg_mod.smoke_config()
    for i, step in enumerate(CLI_STEPS):
        params = jnn.materialize(jtfm.init(jax.random.PRNGKey(i), cfg))
        jckpt.save(str(base / "ckpts"), step, {"params": params})
    return base


def _cli_args(base, out, ckpts):
    return ["--query_file", str(base / "q.jsonl"),
            "--candidate_dir", str(base / "corpus"),
            "--ckpts_dir", str(ckpts), "--qrel_file", str(base / "qrels.txt"),
            "--q_max_len", "8", "--p_max_len", "24", "--chunk_size", "32",
            "--retrieve_k", "20", "--metrics", "MRR@10", "Recall@20",
            "--output_dir", str(out), "--device", "cpu",
            "--encoder", "tests.test_torch_slice:torch_encoder"]


def _copy_ckpts(base, dest):
    import shutil
    shutil.copytree(base / "ckpts", dest)
    return dest


def test_cli_control_plane_selects_gcs_stops_and_soups(cli_space, tmp_path):
    """``--keep_top_k 2 --ensemble_top_k 2 --early_stop`` on four
    checkpoints: the decisions in ``asyncval_control.jsonl`` equal the
    reference's replay of the port's ledger, the STOP marker holds the
    plateau verdict, the soup is validated, and the checkpoint dir keeps
    the top two."""
    from repro_torch.core.cli import main
    ckpts = _copy_ckpts(cli_space, tmp_path / "ckpts")
    out = tmp_path / "out"
    rc = main(_cli_args(cli_space, out, ckpts) + [
        "--keep_top_k", "2", "--ensemble_top_k", "2", "--early_stop",
        "--early_stop_patience", "2", "--early_stop_min_delta", "1.0"])
    assert rc == 0
    with open(out / "asyncval_ledger.jsonl") as f:
        rows = [json.loads(line) for line in f if line.strip()]
    log = tc.ControlEventLog(str(out / "asyncval_control.jsonl"))
    kinds = {e.kind for e in log.events()}
    assert {"select", "gc", "stop", "stop_marker", "ensemble"} <= kinds
    soup = [e for e in log.events() if e.kind == "ensemble"][0]
    assert [r["step"] for r in rows] == list(CLI_STEPS) + [soup.step]
    assert tc.stop_requested(str(out / "STOP"))["reason"] == "plateau"
    assert tc.stop_requested(str(out / "STOP"))["step"] == CLI_STEPS[2]
    kept = ckpt.list_steps(str(ckpts))
    assert len(kept) == 2 and set(kept) <= set(CLI_STEPS) | {soup.step}
    cfg = dict(metric="MRR@10", keep_top_k=2, ensemble_top_k=2,
               early_stop=True, patience=2, min_delta=1.0)
    for pkg in (tc, jc):
        replayed = pkg.replay_ledger(rows, pkg.ControlConfig(**cfg),
                                     expected_tasks=("default",))
        assert _decisions_json(replayed) == \
            [e.to_json() for e in log.decisions()]
    # a restart rehydrates the ranking and validates nothing again
    rc = main(_cli_args(cli_space, out, ckpts) + ["--keep_top_k", "2"])
    assert rc == 0
    assert ckpt.list_steps(str(ckpts)) == kept


def test_cli_handoff_spool_validates_before_commit(cli_space, tmp_path):
    """``--handoff_spool``: a snapshot a trainer spilled is validated
    before its checkpoint commits; its row says so, and it is the row a
    durable validation of the committed checkpoint gives."""
    from repro_torch.core.cli import main
    from repro_torch.handoff import ParamSnapshot, SnapshotSpool
    state, _ = ckpt.restore(str(cli_space / "ckpts"), 30,
                            template=_smoke_template())
    spool = SnapshotSpool(str(tmp_path / "spool"))
    snap = ParamSnapshot.from_tree(30, state)
    spool.publish(30, snap.leaves, snap.treedef_hex, dtypes=snap.dtypes)
    ckpts = tmp_path / "ckpts"
    ckpts.mkdir()                               # nothing committed yet
    out = tmp_path / "out"
    assert main(_cli_args(cli_space, out, ckpts) +
                ["--handoff_spool", str(tmp_path / "spool")]) == 0
    with open(out / "asyncval_ledger.jsonl") as f:
        (row,) = [json.loads(line) for line in f if line.strip()]
    assert row["step"] == 30 and row["handoff"] == "snapshot"
    # the durable route on the committed checkpoint gives the same row
    durable = tmp_path / "durable"
    dck = tmp_path / "dck"
    ckpt.save(str(dck), 30, state)
    assert main(_cli_args(cli_space, durable, dck)) == 0
    with open(durable / "asyncval_ledger.jsonl") as f:
        (drow,) = [json.loads(line) for line in f if line.strip()]
    assert "handoff" not in drow and drow["metrics"] == row["metrics"]


def _smoke_template():
    import dataclasses
    from repro_torch.configs import dr_bert_base
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(dr_bert_base.smoke_config(),
                              compute_dtype=torch.float32)
    return {"params": tfm.param_shapes(cfg)}


def test_cli_control_metric_must_be_computed(cli_space, tmp_path):
    """A control metric the run does not compute fails at parse time, in
    both CLIs."""
    from repro.core.cli import main as jax_main
    from repro_torch.core.cli import main
    extra = ["--early_stop", "--early_stop_metric", "nDCG@5"]
    with pytest.raises(SystemExit):
        main(_cli_args(cli_space, tmp_path / "p", cli_space / "ckpts")
             + extra)
    jargs = _cli_args(cli_space, tmp_path / "j", cli_space / "ckpts")
    jargs = jargs[:jargs.index("--device")] + extra
    with pytest.raises(SystemExit):
        jax_main(jargs)
    assert not (tmp_path / "p").exists()
