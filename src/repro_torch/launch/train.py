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
f32 either way.  The control plane's flags (``--early-stop-*``,
``--overfit-window``, ``--keep-top-k``, ``--ensemble-top-k``) and the
hand-off's (``--handoff*``) raise ``NotImplementedError`` until those parts
are ported (``ROADMAP.md`` A8, A9).  The initial parameters are the port's
draws from ``--seed`` (:func:`repro_torch.models.transformer.init_numpy`),
not the reference's; the batches are the same draws as the reference's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.reporting import JSONLLogger
from repro_torch.core.samplers import FullCorpus, RunFileTopK
from repro_torch.core.suite import (ValidationConfig, ValidationSuite,
                                    ValidationTask)
from repro_torch.core.validator import AsyncValidator
from repro_torch.core.watcher import BudgetPolicy, Policy
from repro_torch.data import corpus as synthetic_ds
from repro_torch.models import transformer as tfm
from repro_torch.models.biencoder import biencoder_spec, contrastive_loss
from repro_torch.train import optim
from repro_torch.train.trainer import Trainer, TrainerConfig

#: flag (attribute) -> its value when unused; any other value raises
_NOT_PORTED = {"early_stop_patience": 0, "early_stop_min_delta": 0.0,
               "overfit_window": 0, "keep_top_k": 0, "ensemble_top_k": 0,
               "handoff": False, "handoff_capacity": 2, "handoff_spool": ""}


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


def run(args) -> dict:
    for name, unused in _NOT_PORTED.items():
        if getattr(args, name, unused) != unused:
            flag = "--" + name.replace("_", "-")
            raise NotImplementedError(
                f"{flag} is not yet ported to repro_torch (the control "
                "plane and the snapshot hand-off: ROADMAP A8, A9)")
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
    # a STOP marker is one run's verdict: clear a stale one, as the
    # reference does
    stop_file = os.path.join(args.workdir, "STOP")
    if os.path.exists(stop_file):
        os.remove(stop_file)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=ckpt_dir, log_every=args.ckpt_every,
                         async_save=True)
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

    policy_kind = getattr(args, "policy", "fifo")
    policy = BudgetPolicy() if policy_kind == "budget" \
        else Policy(kind=policy_kind, stride=getattr(args, "stride", 1))
    validator = AsyncValidator(
        ckpt_dir, suite, policy=policy,
        logger=JSONLLogger(os.path.join(args.workdir, "valid.jsonl")),
        ledger_path=os.path.join(args.workdir, "ledger.jsonl"))

    t0 = time.time()
    if args.sync:
        # paper Fig. 1a: validate inline after each checkpoint
        def on_metrics(step, m):
            if step % args.ckpt_every == 0:
                trainer.saver.wait()
                validator.validate_pending()
        trainer.run(on_metrics=on_metrics)
        validator.validate_pending()
    else:
        # paper Fig. 1b: validation decoupled, runs while training continues
        validator.start()
        trainer.run()
        validator.stop(drain=True)
    wall = time.time() - t0

    results = {
        "wall_time_s": wall,
        "mode": "sync" if args.sync else "async",
        "validated_steps": validator.ledger.validated_steps,
        "metrics": {r.step: r.log_metrics for r in validator.results},
        "errors": list(validator.errors),
        "stopped_early": trainer.stopped_early,
        "stop_verdict": trainer.stop_verdict,
        "best_step": None,
        "kept_checkpoints": None,
        "ensemble": None,
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
    # not yet ported: the control plane (A8) and the hand-off (A9)
    ap.add_argument("--early-stop-patience", type=int, default=0)
    ap.add_argument("--early-stop-min-delta", type=float, default=0.0)
    ap.add_argument("--overfit-window", type=int, default=0)
    ap.add_argument("--keep-top-k", type=int, default=0)
    ap.add_argument("--ensemble-top-k", type=int, default=0)
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "latest_first", "stride", "budget"])
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--handoff", action="store_true")
    ap.add_argument("--handoff-capacity", type=int, default=2)
    ap.add_argument("--handoff-spool", default="")
    return ap


def main(argv=None) -> dict:
    return run(_parser().parse_args(argv))


if __name__ == "__main__":
    main()
