"""The paper's command-line surface (§3), on PyTorch.

    python -m repro_torch.core.cli \\
        --query_file q.jsonl --candidate_dir corpus_dir \\
        --ckpts_dir ckpts/ --qrel_file qrels.txt \\
        --q_max_len 32 --p_max_len 128 \\
        --metrics MRR@10 Recall@100 --report_to csv jsonl \\
        --run_name myrun --write_run --output_dir runs/ \\
        --arch dr-bert-base --impl cuda --score_dtype bf16 [--watch]

The flags are the JAX package's (``python -m repro.core.cli``), with the
impls named ``torch`` (plain PyTorch, the reference's ``xla``) and ``cuda``
(the hand-written topk_mips kernels, the reference's ``pallas``), and one
more: ``--device {cuda,cpu}``.  The default is ``cuda``; without a card the
CLI raises instead of falling back to the CPU.  ``--mode rerank`` /
``average_rank`` (with ``--run_file`` / ``--depth`` for their samplers),
``--engine materialized`` (with ``--rerank_block``) and ``--token_backing
mmap`` (with ``--mmap_dir`` and ``--token_fingerprint``) work as in the
reference, and so do the control plane (``--keep_top_k``, ``--ema``,
``--early_stop*``, ``--stop_file``, ``--ensemble_top_k``: ledger-driven
selection, quality-aware GC, the STOP marker, a checkpoint soup scored
after validation, every decision in ``<run_name>_control.jsonl``), the
hand-off spool (``--handoff_spool``: pre-durable snapshots a trainer
spills, validated ahead of their checkpoint's COMMIT), ``--policy budget``
and the telemetry flags (``--obs_trace``, ``--obs_report``,
``--obs_metrics``) and the serving tier (``--serve``, ``--serve_k``,
``--serve_batch``, ``--serve_flush_ms``, ``--serve_pending``,
``--serve_events``: after validation the control plane's pick, else the
latest checkpoint, is promoted into a device-resident index and the query
file is answered through it; with ``--watch`` every new pick hot-swaps in,
and GC never deletes the checkpoint being served).  Flags of parts not yet
ported raise ``NotImplementedError``: the fleet (``--worker``,
``--worker_id``, ``--capabilities``, ``--lease_ttl``, ``--max_abandons``)
and ``--scan_window``.
"""

from __future__ import annotations

import argparse
import glob
import importlib
import os
import sys
import time

import torch

from repro_torch.core.registry import (ENCODERS, ENGINES, IMPLS, MODES,
                                       SAMPLERS, ensure_builtins,
                                       register_encoder)

#: flag -> its value when unused; any other value raises "not yet ported"
_NOT_PORTED = {
    "worker": False, "worker_id": None, "capabilities": None,
    "lease_ttl": None, "max_abandons": None, "scan_window": None,
}


@register_encoder("arch")
def _arch_encoder(args):
    """Default encoder: a ``--arch`` registry architecture wrapped as a
    bi-encoder on ``--device``."""
    from repro_torch.configs import registry
    from repro_torch.models.biencoder import biencoder_spec
    arch = registry.get(args.arch)
    cfg = arch.smoke_config() if args.smoke else arch.full_config()
    return biencoder_spec(cfg, q_max_len=args.q_max_len,
                          p_max_len=args.p_max_len, device=args.device)


def build_encoder(args):
    """``--encoder module:function`` (called with the parsed args, which
    carry ``device``), a registered encoder name, or the ``--arch``
    default."""
    if args.encoder:
        if ":" in args.encoder:
            mod_name, fn_name = args.encoder.split(":")
            fn = getattr(importlib.import_module(mod_name), fn_name)
            return fn(args)
        return ENCODERS.get(args.encoder)(args)
    return ENCODERS.get("arch")(args)


def load_texts(paths):
    from repro_torch.data.corpus import read_jsonl
    out = {}
    for p in paths:
        out.update(read_jsonl(p))
    return out


def _obs_finish(args, tel) -> None:
    """Flush the trace buffer and write the ``--obs_report`` /
    ``--obs_metrics`` outputs: the registry's summary table and the
    checkpoint-to-verdict latency percentiles."""
    if tel is None:
        return
    tel.flush()
    if args.obs_metrics:
        tel.metrics.dump(args.obs_metrics)
    if args.obs_report:
        from repro_torch.core.validator import CKPT_TO_VERDICT_METRIC
        print(tel.metrics.render())
        hist = tel.metrics.get(CKPT_TO_VERDICT_METRIC)
        if hist is not None and hist.count:
            print(f"[obs] checkpoint-to-verdict: "
                  f"p50={hist.percentile(50):.3f}s "
                  f"p99={hist.percentile(99):.3f}s "
                  f"over {hist.count} verdicts")
        else:
            print("[obs] checkpoint-to-verdict: no verdicts observed")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.core.cli")
    ap.add_argument("--query_file", nargs="+", required=True)
    ap.add_argument("--candidate_dir", required=True)
    ap.add_argument("--ckpts_dir", required=True)
    ap.add_argument("--tokenizer_name_or_path", default=None,
                    help="accepted for CLI compatibility; unused "
                         "(inputs are pre-tokenized)")
    ap.add_argument("--q_max_len", type=int, default=32)
    ap.add_argument("--p_max_len", type=int, default=128)
    ap.add_argument("--qrel_file", required=True)
    ap.add_argument("--run_name", default="asyncval")
    ap.add_argument("--write_run", action="store_true")
    ap.add_argument("--output_dir", default="asyncval_out")
    ap.add_argument("--max_num_valid", type=int, default=None)
    ap.add_argument("--logging_dir", default=None)
    ap.add_argument("--metrics", nargs="+", default=["MRR@10"])
    ap.add_argument("--report_to", nargs="+", default=["csv"],
                    choices=["csv", "jsonl", "tensorboard", "wandb"])
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the encoder and the scoring run (default "
                         "cuda; raises when no GPU is visible)")
    ap.add_argument("--engine", default="streaming",
                    help="validation data path: 'streaming' fused "
                         "encode->top-k (default), 'materialized' "
                         "encode-all-then-retrieve, or any "
                         "@register_engine name")
    ap.add_argument("--impl", default="torch",
                    help="retrieval top-k implementation: 'torch' (plain "
                         "PyTorch, default) or 'cuda' (the hand-written "
                         "topk_mips kernels)")
    ap.add_argument("--chunk_size", type=int, default=None,
                    help="streaming chunk rows (default: batch_size)")
    ap.add_argument("--staging", default="double_buffered",
                    choices=["double_buffered", "sync"])
    ap.add_argument("--staging_depth", type=int, default=2,
                    help="batches copied to the device ahead of compute")
    ap.add_argument("--token_backing", default="memory",
                    choices=["memory", "mmap"],
                    help="TokenStore backing: host RAM (default) or "
                         "memory-mapped files")
    ap.add_argument("--mmap_dir", default=None,
                    help="cache dir for --token_backing mmap (default: "
                         "<output_dir>/token_cache); built once, reused "
                         "across checkpoints and restarts")
    ap.add_argument("--token_fingerprint", default="fast",
                    choices=["fast", "full"],
                    help="mmap cache key: 'fast' (default) is O(1) in "
                         "corpus size but misses in-place mutations of the "
                         "corpus middle; 'full' hashes every text")
    ap.add_argument("--rerank_block", type=int, default=None,
                    help="materialized rerank only: queries per candidate "
                         "gather (default: sized from a 256 MiB budget)")
    ap.add_argument("--fp16", action="store_true",
                    help="accepted for CLI compatibility; the compute dtype "
                         "comes from the architecture config")
    ap.add_argument("--score_dtype", default="f32",
                    choices=["f32", "bf16", "int8"],
                    help="scoring precision of the MIPS data path, recorded "
                         "in every ledger row")
    ap.add_argument("--mode", default="retrieval",
                    help="'retrieval' (default), 'rerank', 'average_rank', "
                         "or any @register_mode name")
    ap.add_argument("--sampler", default="auto",
                    help="corpus subset strategy (default 'auto': from "
                         "--mode/--depth); any @register_sampler name")
    ap.add_argument("--depth", type=int, default=0,
                    help="subset depth (0 = full corpus); needs --run_file")
    ap.add_argument("--run_file", default=None,
                    help="baseline TREC run for subset sampling")
    ap.add_argument("--retrieve_k", type=int, default=100)
    ap.add_argument("--encoder", default=None,
                    help="module:function -> EncoderSpec")
    ap.add_argument("--arch", default="dr-bert-base")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--watch", action="store_true",
                    help="keep polling for new checkpoints (async mode)")
    ap.add_argument("--poll_interval", type=float, default=5.0)
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "latest_first", "stride", "budget"],
                    help="checkpoint scheduling: every checkpoint in order "
                         "(fifo), only the newest (latest_first), every "
                         "--stride-th step (stride), or a stride adapted "
                         "from validation latency vs checkpoint cadence "
                         "(budget)")
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--obs_trace", default=None,
                    help="append lifecycle spans/events to this JSONL trace "
                         "file (export with python -m "
                         "repro_torch.obs.export)")
    ap.add_argument("--obs_report", action="store_true",
                    help="print the metrics-registry summary table at exit")
    ap.add_argument("--obs_metrics", default=None,
                    help="dump the metrics-registry snapshot as JSON to "
                         "this path at exit")
    ap.add_argument("--handoff_spool", default=None,
                    help="lazy snapshot hand-off: also validate pre-durable "
                         "param snapshots a trainer spills to this "
                         "directory (the trainer's --handoff-spool); the "
                         "--ckpts_dir watcher stays the fallback")
    # -- convergence control plane (repro_torch.control) ---------------------
    ap.add_argument("--keep_top_k", type=int, default=0,
                    help="quality-aware checkpoint GC: after each "
                         "validation keep only the top-k checkpoints by the "
                         "control metric plus anything not yet validated "
                         "(0 = GC disabled, keep everything)")
    ap.add_argument("--ema", type=float, default=0.0,
                    help="EMA smoothing factor for the selection metric "
                         "(0 = raw values)")
    ap.add_argument("--early_stop", action="store_true",
                    help="asynchronous early stopping: when the control "
                         "metric plateaus, an atomic STOP marker file is "
                         "published for the trainer to poll")
    ap.add_argument("--early_stop_metric", default=None,
                    help="control-plane metric spec (default: first "
                         "--metrics entry; AverageRank is minimized, others "
                         "maximized); 'task:metric' or a weighted "
                         "'0.5*a:MRR@10 + 0.5*b:MRR@10' aggregate")
    ap.add_argument("--early_stop_patience", type=int, default=3,
                    help="evaluations without >= --early_stop_min_delta "
                         "improvement before stopping")
    ap.add_argument("--early_stop_min_delta", type=float, default=0.0,
                    help="improvement below this counts as a plateau "
                         "evaluation")
    ap.add_argument("--early_stop_window", type=int, default=0,
                    help="history-based overfit detector window (>= 3); it "
                         "needs a train-loss feed, so it only acts "
                         "in-process (repro_torch.launch.train), not in "
                         "this validator-only CLI (0 = off)")
    ap.add_argument("--stop_file", default=None,
                    help="STOP marker path (default: <logging_dir>/STOP)")
    # -- retrieval serving tier (repro_torch.serve) ---------------------------
    ap.add_argument("--serve", action="store_true",
                    help="serve queries against promoted checkpoints "
                         "through the validator's scoring path: one-shot "
                         "mode answers --query_file once after validation; "
                         "--watch keeps a promoter hot-swapping the live "
                         "index on every control-plane pick (the serving "
                         "checkpoint is GC-protected)")
    ap.add_argument("--serve_k", type=int, default=10,
                    help="results per served query")
    ap.add_argument("--serve_batch", type=int, default=8,
                    help="query micro-batch size (one fixed encode shape)")
    ap.add_argument("--serve_flush_ms", type=float, default=4.0,
                    help="max-latency flush for partial micro-batches")
    ap.add_argument("--serve_pending", type=int, default=256,
                    help="admission bound on in-flight requests (beyond "
                         "it submits fail fast instead of queueing)")
    ap.add_argument("--serve_events", default=None,
                    help="replayable swap-event JSONL (default: "
                         "<logging_dir>/<run_name>_serve.jsonl)")
    ap.add_argument("--ensemble_top_k", type=int, default=0,
                    help="after validation ends, greedy-soup the top-k "
                         "checkpoints by the control metric into a virtual "
                         "checkpoint, commit it and validate it through "
                         "the normal path (0 = off)")
    for name, unused in _NOT_PORTED.items():
        if unused is False:
            ap.add_argument(f"--{name}", action="store_true",
                            help="not yet ported")
        else:
            ap.add_argument(f"--{name}", default=None, help="not yet ported")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    for name, unused in _NOT_PORTED.items():
        if getattr(args, name) != unused:
            raise NotImplementedError(f"--{name} is not yet ported to "
                                      "repro_torch")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) but no CUDA device "
                           "is visible; pass --device cpu to run on the CPU")

    ensure_builtins()
    for reg, value in ((ENGINES, args.engine), (IMPLS, args.impl),
                       (MODES, args.mode)):
        try:
            reg.get(value)
        except ValueError as e:
            ap.error(str(e))
    if args.sampler != "auto":
        try:
            SAMPLERS.get(args.sampler)
        except ValueError as e:
            ap.error(str(e))
        chosen_sampler = args.sampler
    elif args.mode == "rerank":
        chosen_sampler = "rerank_topk"
    elif args.mode == "average_rank":
        chosen_sampler = "qrel_pool"
    else:
        chosen_sampler = "run_topk" if args.depth else "full"
    if chosen_sampler in ("run_topk", "rerank_topk") and not args.run_file:
        ap.error(f"sampler {chosen_sampler!r} subsets from a baseline run "
                 "(--depth picks its depth); pass --run_file")

    # the control metric is checked before any corpus IO: a typo would
    # otherwise raise inside every controller call
    cmetric = None
    if args.keep_top_k or args.early_stop or args.ensemble_top_k:
        from repro_torch.control import MetricSpec
        cmetric = args.early_stop_metric or args.metrics[0]
        computed = set(args.metrics) | ({"AverageRank"}
                                        if args.mode == "average_rank"
                                        else set())
        # one task named "default": bare and default-qualified keys
        computed |= {f"default:{m}" for m in set(computed)}
        try:
            spec_keys = MetricSpec.parse(cmetric).keys()
        except ValueError as e:
            ap.error(str(e))
        missing = [k for k in spec_keys if k not in computed]
        if missing:
            ap.error(f"--early_stop_metric {cmetric!r} references "
                     f"{missing} not computed by this run; choose from "
                     f"{sorted(computed)}")

    from repro_torch.core.metrics import read_trec_qrels, read_trec_run
    from repro_torch.core.reporting import CSVLogger, JSONLLogger, MultiLogger
    from repro_torch.core.suite import (ValidationConfig, ValidationSuite,
                                        ValidationTask)
    from repro_torch.core.validator import AsyncValidator
    from repro_torch.core.watcher import BudgetPolicy, Policy

    spec = build_encoder(args)
    corpus = load_texts(sorted(
        glob.glob(os.path.join(args.candidate_dir, "*.json*"))))
    queries = load_texts(args.query_file)
    qrels = read_trec_qrels(args.qrel_file)
    print(f"[asyncval] corpus={len(corpus)} queries={len(queries)} "
          f"qrels={len(qrels)} device={spec.device}", file=sys.stderr)
    baseline_run = read_trec_run(args.run_file) if args.run_file else None
    sampler = SAMPLERS.get(chosen_sampler)(depth=args.depth)

    # telemetry observes only: without an --obs_* flag no clock is read
    # for it and nothing is written
    tel = None
    if args.obs_trace or args.obs_report or args.obs_metrics:
        from repro_torch.obs import Telemetry
        tel = Telemetry(args.obs_trace, process="cli",
                        attrs={"run": args.run_name})

    mmap_dir = args.mmap_dir
    if args.token_backing == "mmap" and not mmap_dir:
        mmap_dir = os.path.join(args.output_dir, "token_cache")
    vcfg = ValidationConfig(metrics=tuple(args.metrics), mode=args.mode,
                            k=args.retrieve_k, batch_size=args.batch_size,
                            impl=args.impl, engine=args.engine,
                            chunk_size=args.chunk_size, staging=args.staging,
                            staging_depth=args.staging_depth,
                            token_backing=args.token_backing,
                            mmap_dir=mmap_dir,
                            token_fingerprint=args.token_fingerprint,
                            rerank_block=args.rerank_block,
                            score_dtype=args.score_dtype,
                            write_run=args.write_run,
                            output_dir=args.output_dir,
                            run_tag=args.run_name, telemetry=tel)
    suite = ValidationSuite(spec, [
        ValidationTask("default", corpus, queries, qrels,
                       sampler=sampler, baseline_run=baseline_run),
    ], vcfg)
    suite.build_engines()

    logdir = args.logging_dir or args.output_dir
    loggers = []
    for r in args.report_to:
        if r in ("csv", "tensorboard"):      # tensorboard -> CSV twin
            loggers.append(CSVLogger(os.path.join(
                logdir, f"{args.run_name}_metrics.csv")))
        else:                                # wandb -> JSONL twin
            loggers.append(JSONLLogger(os.path.join(
                logdir, f"{args.run_name}_metrics.jsonl")))
    os.makedirs(logdir, exist_ok=True)

    control = None
    if cmetric is not None:
        from repro_torch.control import ControlConfig, ControlPlane, \
            metric_mode
        ccfg = ControlConfig(
            metric=cmetric, mode=metric_mode(cmetric),
            keep_top_k=args.keep_top_k, ema=args.ema,
            early_stop=args.early_stop,
            patience=args.early_stop_patience,
            min_delta=args.early_stop_min_delta,
            overfit_window=args.early_stop_window,
            ensemble_top_k=args.ensemble_top_k)
        stop_path = None
        if args.early_stop:
            stop_path = args.stop_file or os.path.join(logdir, "STOP")
            if os.path.exists(stop_path):
                # a previous session's verdict: a trainer polling this path
                # must not halt before this session decides anything
                os.remove(stop_path)
        control = ControlPlane(
            args.ckpts_dir, ccfg, stop_path=stop_path,
            event_path=os.path.join(logdir, f"{args.run_name}_control.jsonl"),
            telemetry=tel)

    serve = None
    if args.serve:
        from repro_torch.serve import (AdmissionController, IndexBuilder,
                                       Promoter, QueryService, ServeConfig)
        # the validator's scoring knobs (score_dtype, impl, token-store
        # geometry), so the answers served are the numbers the ledger holds
        scfg = ServeConfig(k=args.serve_k, score_dtype=args.score_dtype,
                           impl=args.impl, batch_size=args.batch_size,
                           chunk_size=args.chunk_size,
                           max_batch=args.serve_batch,
                           flush_ms=args.serve_flush_ms,
                           max_pending=args.serve_pending,
                           token_backing=args.token_backing,
                           mmap_dir=mmap_dir,
                           token_fingerprint=args.token_fingerprint)
        serve_service = QueryService(
            spec, k=args.serve_k, max_batch=args.serve_batch,
            flush_ms=args.serve_flush_ms,
            admission=AdmissionController(args.serve_pending),
            telemetry=tel)
        serve_promoter = Promoter(
            IndexBuilder(spec, corpus, scfg), serve_service,
            args.ckpts_dir, telemetry=tel,
            # the in-process control plane's live pick; without one, the
            # latest committed checkpoint (the promoter's default)
            target_fn=((lambda: control.selector.best_step)
                       if control is not None else None),
            log=args.serve_events or os.path.join(
                logdir, f"{args.run_name}_serve.jsonl"))
        serve = (serve_service, serve_promoter)

    snapshots = None
    if args.handoff_spool:
        from repro_torch.handoff import SnapshotSpool
        snapshots = SnapshotSpool(args.handoff_spool)
    validator = AsyncValidator(
        args.ckpts_dir, suite, logger=MultiLogger(*loggers),
        policy=BudgetPolicy() if args.policy == "budget"
        else Policy(kind=args.policy, stride=args.stride),
        max_num_valid=args.max_num_valid, controller=control,
        ledger_path=os.path.join(logdir, f"{args.run_name}_ledger.jsonl"),
        poll_interval_s=args.poll_interval, telemetry=tel,
        snapshots=snapshots,
        # GC never deletes the checkpoint behind the live (or promoting)
        # serving index
        extra_protect=serve[1].protect_set if serve is not None else None)
    if control is not None:
        # restart: warm the ranking from the previous session's rows (old
        # steps are never validated again, and a cold selector would GC
        # the previous session's best checkpoints)
        control.rehydrate(validator.ledger.rows(),
                          expected_tasks=suite.task_names)

    if args.watch:
        print("[asyncval] watching", args.ckpts_dir, file=sys.stderr)
        try:
            while args.max_num_valid is None \
                    or len(validator.results) < args.max_num_valid:
                n = validator.validate_pending()
                for r in validator.results[len(validator.results) - n:]:
                    print(f"[asyncval] step {r.step}: {r.log_metrics} "
                          f"({r.timings['total_s']:.1f}s)")
                if serve is not None and serve[1].poll_once():
                    # zero downtime: the old index answered meanwhile
                    print(f"[serve] hot-swap -> step "
                          f"{serve[0].live_step()}", file=sys.stderr)
                if control is not None and control.stopped and n == 0:
                    # the STOP marker is out and the backlog is drained
                    print("[asyncval] early stop "
                          f"({control.earlystop.reason}) — exiting watch",
                          file=sys.stderr)
                    break
                time.sleep(args.poll_interval)
        except KeyboardInterrupt:
            pass
    else:
        validator.validate_all_existing()
        for r in validator.results:
            print(f"[asyncval] step {r.step}: {r.log_metrics} "
                  f"({r.timings['total_s']:.1f}s)")

    if serve is not None:
        serve_service, serve_promoter = serve
        serve_promoter.poll_once()       # one-shot: promote the final pick
        if serve_service.live is None:
            print("[serve] no promotable checkpoint; skipping serve pass",
                  file=sys.stderr)
        else:
            resp = serve_service.answer(sorted(queries.items()))
            lat = sorted(r.latency_s for r in resp)
            p50 = lat[len(lat) // 2] * 1e3
            p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3
            print(f"[serve] answered {len(resp)} queries: "
                  f"p50={p50:.2f}ms p99={p99:.2f}ms "
                  f"step={serve_service.live_step()}")

    if control is not None and args.ensemble_top_k:
        from repro_torch.control import MetricSpec
        cspec = MetricSpec.parse(control.cfg.metric)
        # scoring passes write no TREC run: each soup candidate would
        # overwrite the run file of step 0
        vstep = control.build_ensemble(
            lambda p: cspec.value(
                suite.validate_params(p, write_runs=False).metrics),
            template=validator.worker.template)
        if vstep is not None:
            # scored through the normal path, past the watcher policy
            validator.validate_step(vstep)
            res = next((r for r in validator.results if r.step == vstep),
                       None)
            if res is not None:
                print(f"[asyncval] ensemble step {vstep} "
                      f"(soup of {control.ensemble_members}): "
                      f"{res.log_metrics}")
    for step, err in validator.errors:
        print(f"[asyncval] step {step} failed: {err}", file=sys.stderr)
    _obs_finish(args, tel)
    return 0 if not validator.errors else 1


if __name__ == "__main__":
    sys.exit(main())
