"""End-to-end training with asynchronous checkpoint validation
(``repro/launch/train.py``).

The Asyncval deployment (paper Fig. 1b): the trainer commits checkpoints to
a directory; a decoupled validator watches the directory and validates each
checkpoint while training continues.  Here the validator is a thread of the
same process on the same device, on its own CUDA stream.  Training never
blocks on validation.

    python -m repro_torch.launch.train --steps 60 --ckpt-every 10 \\
        --workdir /tmp/asyncval_run [--sync] [--full] [--device cpu]

``--sync`` runs the paper's Figure-1a baseline instead (validation inline,
after each checkpoint).  The flags and defaults are the reference's, plus
``--device {cuda,cpu}`` (default ``cuda``; it raises without a GPU).  The
smoke config trains by default, ``--full`` the full-width dr-bert-base, in
f32 either way.  The initial parameters are the port's draws from
``--seed`` (:func:`repro_torch.models.transformer.init_numpy`), not the
reference's; the batches are the same draws as the reference's.

The control plane closes the loop: ``--early-stop-patience`` (with
``--early-stop-min-delta`` and ``--overfit-window``) lets the validator
write the STOP marker the trainer polls, ``--keep-top-k`` deletes
checkpoints outside the top k by MRR@10 once validated, and
``--ensemble-top-k`` soups the top checkpoints after the drain into a
virtual checkpoint that is validated like any other; every decision is in
``control.jsonl``.  ``--handoff`` validates each checkpoint from a host
snapshot of its params the moment the device-to-host copy lands, before the
durable save commits (``--handoff-capacity`` snapshots at most;
``--handoff-spool`` mirrors them to a directory for validators in other
processes).  :func:`make_handoff`, :func:`make_control` and :func:`drive`
are the pieces :func:`run` puts together, for callers that bring their own
trainer and validator.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import registry
from repro_torch.control import ControlConfig, ControlPlane, MetricSpec
from repro_torch.core.reporting import JSONLLogger
from repro_torch.core.samplers import FullCorpus, RunFileTopK
from repro_torch.core.suite import (ValidationConfig, ValidationSuite,
                                    ValidationTask)
from repro_torch.core.validator import AsyncValidator
from repro_torch.core.watcher import BudgetPolicy, Policy
from repro_torch.data import corpus as synthetic_ds
from repro_torch.handoff import SnapshotChannel, SnapshotSpool
from repro_torch.models import transformer as tfm
from repro_torch.models.biencoder import biencoder_spec, contrastive_loss
from repro_torch.train import optim
from repro_torch.train.trainer import Trainer, TrainerConfig


def _contrastive_batches(ds, spec, batch_size: int, n_psg: int = 2):
    """Deterministic step -> batch function from the synthetic dataset, on
    the spec's device: the reference's numpy draws, so both packages train
    on identical batches."""
    qids = sorted(ds.qrels)
    docids = list(ds.corpus)
    by_qid_gold = {q: next(iter(ds.qrels[q])) for q in qids}

    def make(step: int):
        rng = np.random.default_rng(1000 + step)
        pick = rng.choice(len(qids), size=batch_size)
        q_tok, p_tok = [], []
        for i in pick:
            qid = qids[i]
            q_tok.append(ds.queries[qid])
            gold = by_qid_gold[qid]
            negs = rng.choice(len(docids), size=n_psg - 1)
            p_tok.append([ds.corpus[gold]]
                         + [ds.corpus[docids[j]] for j in negs])
        qt, qm = synthetic_ds.pad_batch(q_tok, spec.q_max_len)
        flat = [t for ps in p_tok for t in ps]
        pt, pm = synthetic_ds.pad_batch(flat, spec.p_max_len)
        B = batch_size

        def put(a):
            return torch.from_numpy(a).to(spec.device)

        return {"q_tokens": put(qt), "q_mask": put(qm),
                "p_tokens": put(pt).reshape(B, n_psg, -1),
                "p_mask": put(pm).reshape(B, n_psg, -1)}

    return make


def make_handoff(handoff: bool, capacity: int = 2, spool: str = "",
                 telemetry=None) -> Optional[SnapshotChannel]:
    """The trainer -> validator snapshot ring (``--handoff``), mirrored to
    ``spool`` when one is named; ``None`` without ``handoff``."""
    if not handoff:
        return None
    return SnapshotChannel(capacity=capacity,
                           spool=SnapshotSpool(spool) if spool else None,
                           telemetry=telemetry)


def make_control(ckpt_dir: str, workdir: str, *, patience: int = 0,
                 min_delta: float = 0.0, overfit_window: int = 0,
                 keep_top_k: int = 0, ensemble_top_k: int = 0,
                 snapshots: Optional[SnapshotChannel] = None,
                 telemetry=None) -> Optional[ControlPlane]:
    """The control plane on MRR@10 (``None`` when every option is off):
    early stop through ``<workdir>/STOP``, quality-aware GC held until a
    snapshot-scored step is durable, soups, and ``<workdir>/control.jsonl``
    for the decisions."""
    if not (patience > 0 or keep_top_k > 0 or ensemble_top_k > 0):
        return None
    ccfg = ControlConfig(metric="MRR@10", mode="max", keep_top_k=keep_top_k,
                         early_stop=patience > 0, patience=max(patience, 1),
                         min_delta=min_delta, overfit_window=overfit_window,
                         ensemble_top_k=ensemble_top_k)
    return ControlPlane(ckpt_dir, ccfg,
                        stop_path=os.path.join(workdir, "STOP"),
                        event_path=os.path.join(workdir, "control.jsonl"),
                        telemetry=telemetry,
                        durability=snapshots.durability
                        if snapshots is not None else None)


def drive(trainer: Trainer, validator: AsyncValidator, suite,
          control: Optional[ControlPlane], *, sync: bool, ckpt_every: int,
          on_metrics: Optional[Callable[[int, dict], None]] = None
          ) -> Optional[dict]:
    """Train with validation, Fig. 1b (the validator thread beside the
    trainer, drained at the end) or with ``sync`` Fig. 1a (inline after
    each checkpoint); feed the control plane the train losses; after the
    drain release the GC holds and, with ``ensemble_top_k``, soup the top
    checkpoints and validate the soup.  Returns the soup's ``{"step",
    "members", "metrics"}`` (or ``None``).  ``on_metrics`` also receives
    the trainer's metrics."""

    def feed(step, m):
        if control is not None:
            control.note_train(step, m)     # the overfit detector's input
        if on_metrics is not None:
            on_metrics(step, m)

    if sync:
        # paper Fig. 1a: validate inline after each checkpoint
        def inline(step, m):
            feed(step, m)
            if step % ckpt_every == 0:
                trainer.saver.wait()
                validator.validate_pending()
        trainer.run(on_metrics=inline)
        validator.validate_pending()
    else:
        # paper Fig. 1b: validation decoupled, runs while training continues
        validator.start()
        trainer.run(on_metrics=feed)
        validator.stop(drain=True)
    if control is None:
        return None
    # every durable save has landed (trainer.run waits for the saver):
    # release any GC held on snapshot-scored evidence
    control.maybe_gc(validator)
    if control.cfg.ensemble_top_k <= 0:
        return None
    spec = MetricSpec.parse(control.cfg.metric)
    vstep = control.build_ensemble(
        lambda p: spec.value(suite.validate_params(
            p, write_runs=False).metrics),
        template=validator.worker.template)
    if vstep is None:
        return None
    # past any watcher policy: the soup's step must be scored
    validator.validate_step(vstep)
    res = next((r for r in validator.results if r.step == vstep), None)
    return {"step": vstep, "members": control.ensemble_members,
            "metrics": res.log_metrics if res else None}


def run(args) -> dict:
    device = getattr(args, "device", "cuda")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) but no CUDA device "
                           "is visible; pass --device cpu to run on the CPU")
    os.makedirs(args.workdir, exist_ok=True)
    ckpt_dir = os.path.join(args.workdir, "ckpts")

    arch = registry.get(args.arch)
    if arch.family != "biencoder":
        raise ValueError("launch.train trains the paper's DR "
                         f"bi-encoder; {args.arch} is a {arch.family}")
    cfg = arch.smoke_config() if not args.full else arch.full_config()
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    spec = biencoder_spec(cfg, q_max_len=args.q_max_len,
                          p_max_len=args.p_max_len, device=device)

    ds = synthetic_ds.synthetic_retrieval_dataset(
        args.seed, n_passages=args.corpus_size, n_queries=args.n_queries,
        vocab=cfg.vocab_size)
    baseline_run = synthetic_ds.lexical_baseline_run(ds, k=args.depth)

    params = tfm.params_from_numpy(tfm.init_numpy(cfg, args.seed), device)
    opt = optim.adamw(args.lr)
    # the control flags default off for callers with a plain args object
    patience = getattr(args, "early_stop_patience", 0)
    snapshots = make_handoff(getattr(args, "handoff", False),
                             getattr(args, "handoff_capacity", 2),
                             getattr(args, "handoff_spool", ""))
    # a STOP marker is one run's verdict: clear a stale one, so a restarted
    # run trains instead of halting at step 0
    stop_file = os.path.join(args.workdir, "STOP")
    if os.path.exists(stop_file):
        os.remove(stop_file)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=ckpt_dir, log_every=args.ckpt_every,
                         async_save=True,
                         stop_file=stop_file if patience > 0 else None,
                         snapshots=snapshots)
    trainer = Trainer(tcfg, lambda p, b: contrastive_loss(p, spec, b),
                      opt, params,
                      _contrastive_batches(ds, spec, args.batch_size),
                      logger=JSONLLogger(os.path.join(args.workdir,
                                                      "train.jsonl")))

    sampler = RunFileTopK(depth=args.depth) if args.subset else FullCorpus()
    vcfg = ValidationConfig(metrics=("MRR@10", "Recall@100"),
                            k=100, batch_size=args.batch_size)
    # a one-task suite named "default": the reference launcher's rows
    suite = ValidationSuite(spec, [
        ValidationTask("default", ds.corpus, ds.queries, ds.qrels,
                       sampler=sampler, baseline_run=baseline_run),
    ], vcfg)
    suite.build_engines()

    control = make_control(
        ckpt_dir, args.workdir, patience=patience,
        min_delta=getattr(args, "early_stop_min_delta", 0.0),
        overfit_window=getattr(args, "overfit_window", 0),
        keep_top_k=getattr(args, "keep_top_k", 0),
        ensemble_top_k=getattr(args, "ensemble_top_k", 0),
        snapshots=snapshots)
    policy_kind = getattr(args, "policy", "fifo")
    policy = BudgetPolicy() if policy_kind == "budget" \
        else Policy(kind=policy_kind, stride=getattr(args, "stride", 1))
    validator = AsyncValidator(
        ckpt_dir, suite, policy=policy, controller=control,
        logger=JSONLLogger(os.path.join(args.workdir, "valid.jsonl")),
        ledger_path=os.path.join(args.workdir, "ledger.jsonl"),
        snapshots=snapshots)
    if control is not None:
        # restart: warm the ranking from the previous session's ledger, so
        # quality-aware GC keeps its already-validated best checkpoints
        control.rehydrate(validator.ledger.rows(),
                          expected_tasks=suite.task_names)

    t0 = time.time()
    ensemble = drive(trainer, validator, suite, control, sync=args.sync,
                     ckpt_every=args.ckpt_every)
    wall = time.time() - t0

    results = {
        "wall_time_s": wall,
        "mode": "sync" if args.sync else "async",
        "validated_steps": validator.ledger.validated_steps,
        "metrics": {r.step: r.log_metrics for r in validator.results},
        "errors": list(validator.errors),
        "stopped_early": trainer.stopped_early,
        "stop_verdict": trainer.stop_verdict,
        "best_step": control.selector.best_step if control else None,
        "kept_checkpoints": ckpt.list_steps(ckpt_dir) if control else None,
        "ensemble": ensemble,
    }
    with open(os.path.join(args.workdir, "summary.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results, indent=1))
    return results


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="dr-bert-base")
    ap.add_argument("--workdir", default="/tmp/asyncval_train")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--corpus-size", type=int, default=600)
    ap.add_argument("--n-queries", type=int, default=50)
    ap.add_argument("--q-max-len", type=int, default=12)
    ap.add_argument("--p-max-len", type=int, default=28)
    ap.add_argument("--depth", type=int, default=20)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--subset", action="store_true")
    ap.add_argument("--sync", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where training and validation run (default cuda; "
                         "raises when no GPU is visible)")
    # convergence control plane (repro_torch.control)
    ap.add_argument("--early-stop-patience", type=int, default=0,
                    help="evaluations without improvement before the "
                         "validator publishes the STOP marker (0 = off)")
    ap.add_argument("--early-stop-min-delta", type=float, default=0.0)
    ap.add_argument("--overfit-window", type=int, default=0,
                    help="history-based overfit detector window (>= 3; "
                         "0 = off)")
    ap.add_argument("--keep-top-k", type=int, default=0,
                    help="quality-aware GC: keep top-k checkpoints by "
                         "MRR@10 plus unvalidated ones (0 = keep all)")
    ap.add_argument("--ensemble-top-k", type=int, default=0,
                    help="greedy-soup the top-k checkpoints into a virtual "
                         "checkpoint after training (0 = off)")
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "latest_first", "stride", "budget"])
    ap.add_argument("--stride", type=int, default=1)
    # lazy snapshot hand-off (repro_torch.handoff)
    ap.add_argument("--handoff", action="store_true",
                    help="validate checkpoints from host snapshots the "
                         "moment the device-to-host copy lands, before the "
                         "durable save commits (the watcher stays the "
                         "fallback; GC still waits for the durable COMMIT)")
    ap.add_argument("--handoff-capacity", type=int, default=2,
                    help="snapshot ring size; over capacity the oldest "
                         "unclaimed snapshot is dropped and its step falls "
                         "back to the watcher (training never blocks)")
    ap.add_argument("--handoff-spool", default="",
                    help="spill directory (e.g. under /dev/shm) mirroring "
                         "the ring for validators in other processes; "
                         "empty = in-process hand-off only")
    return ap


def main(argv=None) -> dict:
    return run(_parser().parse_args(argv))


if __name__ == "__main__":
    main()
