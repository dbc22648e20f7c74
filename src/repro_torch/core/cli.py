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
CLI raises instead of falling back to the CPU.  Flags of parts not yet
ported (serving, the control plane, the fleet, hand-off, telemetry, the
materialized engine, rerank modes, mmap token stores, the budget policy)
raise ``NotImplementedError``.
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
    "serve": False, "serve_k": None, "serve_batch": None,
    "serve_flush_ms": None, "serve_pending": None, "serve_events": None,
    "keep_top_k": None, "ema": None, "early_stop": False,
    "early_stop_metric": None, "early_stop_patience": None,
    "early_stop_min_delta": None, "early_stop_window": None,
    "stop_file": None, "ensemble_top_k": None,
    "worker": False, "worker_id": None, "capabilities": None,
    "lease_ttl": None, "max_abandons": None, "handoff_spool": None,
    "obs_trace": None, "obs_report": False, "obs_metrics": None,
    "mmap_dir": None, "token_fingerprint": None, "rerank_block": None,
    "scan_window": None,
}
#: (flag, value) pairs of ported flags whose value selects an unported part
_NOT_PORTED_VALUES = {("engine", "materialized"), ("mode", "rerank"),
                      ("mode", "average_rank"), ("token_backing", "mmap"),
                      ("policy", "budget")}


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
                    help="validation data path: 'streaming' (the only one "
                         "ported so far) or any @register_engine name")
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
                    choices=["memory", "mmap"])
    ap.add_argument("--fp16", action="store_true",
                    help="accepted for CLI compatibility; the compute dtype "
                         "comes from the architecture config")
    ap.add_argument("--score_dtype", default="f32",
                    choices=["f32", "bf16", "int8"],
                    help="scoring precision of the MIPS data path, recorded "
                         "in every ledger row")
    ap.add_argument("--mode", default="retrieval")
    ap.add_argument("--sampler", default="auto")
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
                    choices=["fifo", "latest_first", "stride", "budget"])
    ap.add_argument("--stride", type=int, default=1)
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
    for name, value in _NOT_PORTED_VALUES:
        if getattr(args, name) == value:
            raise NotImplementedError(f"--{name} {value} is not yet ported "
                                      "to repro_torch")
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
    else:
        chosen_sampler = "run_topk" if args.depth else "full"
    if chosen_sampler in ("run_topk", "rerank_topk") and not args.run_file:
        ap.error(f"sampler {chosen_sampler!r} subsets from a baseline run "
                 "(--depth picks its depth); pass --run_file")

    from repro_torch.core.metrics import read_trec_qrels, read_trec_run
    from repro_torch.core.reporting import CSVLogger, JSONLLogger, MultiLogger
    from repro_torch.core.suite import (ValidationConfig, ValidationSuite,
                                        ValidationTask)
    from repro_torch.core.validator import AsyncValidator
    from repro_torch.core.watcher import Policy

    spec = build_encoder(args)
    corpus = load_texts(sorted(
        glob.glob(os.path.join(args.candidate_dir, "*.json*"))))
    queries = load_texts(args.query_file)
    qrels = read_trec_qrels(args.qrel_file)
    print(f"[asyncval] corpus={len(corpus)} queries={len(queries)} "
          f"qrels={len(qrels)} device={spec.device}", file=sys.stderr)
    baseline_run = read_trec_run(args.run_file) if args.run_file else None
    sampler = SAMPLERS.get(chosen_sampler)(depth=args.depth)

    vcfg = ValidationConfig(metrics=tuple(args.metrics), mode=args.mode,
                            k=args.retrieve_k, batch_size=args.batch_size,
                            impl=args.impl, engine=args.engine,
                            chunk_size=args.chunk_size, staging=args.staging,
                            staging_depth=args.staging_depth,
                            token_backing=args.token_backing,
                            score_dtype=args.score_dtype,
                            write_run=args.write_run,
                            output_dir=args.output_dir,
                            run_tag=args.run_name)
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
    validator = AsyncValidator(
        args.ckpts_dir, suite, logger=MultiLogger(*loggers),
        policy=Policy(kind=args.policy, stride=args.stride),
        max_num_valid=args.max_num_valid,
        ledger_path=os.path.join(logdir, f"{args.run_name}_ledger.jsonl"),
        poll_interval_s=args.poll_interval)

    if args.watch:
        print("[asyncval] watching", args.ckpts_dir, file=sys.stderr)
        try:
            while args.max_num_valid is None \
                    or len(validator.results) < args.max_num_valid:
                n = validator.validate_pending()
                for r in validator.results[len(validator.results) - n:]:
                    print(f"[asyncval] step {r.step}: {r.log_metrics} "
                          f"({r.timings['total_s']:.1f}s)")
                time.sleep(args.poll_interval)
        except KeyboardInterrupt:
            pass
    else:
        validator.validate_all_existing()
        for r in validator.results:
            print(f"[asyncval] step {r.step}: {r.log_metrics} "
                  f"({r.timings['total_s']:.1f}s)")
    for step, err in validator.errors:
        print(f"[asyncval] step {step} failed: {err}", file=sys.stderr)
    return 0 if not validator.errors else 1


if __name__ == "__main__":
    sys.exit(main())
