"""Retrieval serving entry point — queries against promoted checkpoints
(``repro/launch/serve.py``).

The serving half of the asyncval loop: builds a device-resident index
from the best (or latest) committed checkpoint through the validator's
own encode/score machinery (``repro_torch.serve``), answers a query file
through the micro-batching :class:`~repro_torch.serve.service.
QueryService`, and — with ``--watch`` — keeps a
:class:`~repro_torch.serve.promoter.Promoter` tailing the control plane's
``select`` events so every newly promoted checkpoint hot-swaps into
service with zero downtime.

    python -m repro_torch.launch.serve \\
        --candidate_dir corpus_dir --query_file q.jsonl \\
        --ckpts_dir ckpts/ --events logs/run_control.jsonl \\
        --k 10 --score_dtype f32 --impl cuda --max_batch 8 --flush_ms 4 \\
        --encoder mymodule:my_spec_builder [--watch] [--device cpu]

``--device`` defaults to ``cuda`` and raises without a card; ``--impl
torch`` scores in plain PyTorch, ``--impl cuda`` through the topk_mips
kernels.  Answers are the validator's for the same checkpoint
(tests/test_torch_serve_parity.py).  The LM prefill/decode demo lives at
``repro_torch.launch.lm_demo``; its ``serve_batch`` is re-exported here,
as the reference does.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import torch

# compatibility re-export: the LM generation demo predates the serving
# tier and external callers import its batch helper from this module
from repro_torch.launch.lm_demo import serve_batch  # noqa: F401


def _percentile(xs, q):
    xs = sorted(xs)
    if not xs:
        return float("nan")
    pos = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[pos]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="serve dense-retrieval queries against control-plane-"
                    "promoted checkpoints, through the validator's exact "
                    "scoring path")
    ap.add_argument("--query_file", nargs="+", required=True)
    ap.add_argument("--candidate_dir", required=True)
    ap.add_argument("--ckpts_dir", required=True)
    ap.add_argument("--step", type=int, default=None,
                    help="serve this checkpoint step (default: the newest "
                         "'select' winner in --events, else the latest "
                         "committed checkpoint)")
    ap.add_argument("--events", default=None,
                    help="control-plane event JSONL to tail for 'select' "
                         "promotions (the validator CLI writes "
                         "<logdir>/<run>_control.jsonl)")
    ap.add_argument("--serve_events", default=None,
                    help="where to record replayable swap events "
                         "(default: <ckpts_dir>/serve_events.jsonl)")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--score_dtype", default="f32",
                    choices=["f32", "bf16", "int8"])
    ap.add_argument("--impl", default="torch", choices=["torch", "cuda"],
                    help="top-k: plain PyTorch, or the topk_mips kernels")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the encoder and the index live (default "
                         "cuda; raises when no GPU is visible)")
    ap.add_argument("--batch_size", type=int, default=64,
                    help="corpus encode chunk rows (index build)")
    ap.add_argument("--max_batch", type=int, default=8,
                    help="query micro-batch size")
    ap.add_argument("--flush_ms", type=float, default=4.0,
                    help="max-latency flush for partial micro-batches")
    ap.add_argument("--max_pending", type=int, default=256,
                    help="admission bound on in-flight requests")
    ap.add_argument("--q_max_len", type=int, default=32)
    ap.add_argument("--p_max_len", type=int, default=128)
    ap.add_argument("--encoder", default=None,
                    help="module:function -> EncoderSpec (called with the "
                         "parsed args, which carry device)")
    ap.add_argument("--arch", default="dr-bert-base")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--watch", action="store_true",
                    help="keep polling --events and hot-swap newly "
                         "promoted checkpoints (zero downtime)")
    ap.add_argument("--poll_interval", type=float, default=1.0)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) but no CUDA device "
                           "is visible; pass --device cpu to run on the CPU")

    from repro_torch.core.cli import build_encoder, load_texts
    from repro_torch.serve import (AdmissionController, IndexBuilder,
                                   Promoter, QueryService, ServeConfig)

    spec = build_encoder(args)
    corpus = load_texts(sorted(
        glob.glob(os.path.join(args.candidate_dir, "*.json*"))))
    queries = load_texts(args.query_file)
    print(f"[serve] corpus={len(corpus)} queries={len(queries)}",
          file=sys.stderr)

    cfg = ServeConfig(k=args.k, score_dtype=args.score_dtype,
                      impl=args.impl, batch_size=args.batch_size,
                      max_batch=args.max_batch, flush_ms=args.flush_ms,
                      max_pending=args.max_pending)
    builder = IndexBuilder(spec, corpus, cfg)
    service = QueryService(spec, k=cfg.k, max_batch=cfg.max_batch,
                           flush_ms=cfg.flush_ms,
                           admission=AdmissionController(cfg.max_pending))
    promoter = Promoter(
        builder, service, args.ckpts_dir,
        target_fn=(lambda: args.step) if args.step is not None else None,
        control_events=args.events,
        log=args.serve_events or os.path.join(args.ckpts_dir,
                                              "serve_events.jsonl"),
        poll_interval_s=args.poll_interval)
    if not promoter.poll_once():
        print("[serve] no committed checkpoint to promote", file=sys.stderr)
        return 1
    print(f"[serve] live step {service.live_step()} "
          f"({builder.store.n_texts} docs, score_dtype={cfg.score_dtype})",
          file=sys.stderr)

    responses = service.answer(list(queries.items()))
    lats = [r.latency_s for r in responses]
    print(f"[serve] answered {len(responses)} queries: "
          f"p50={_percentile(lats, 50)*1e3:.2f}ms "
          f"p99={_percentile(lats, 99)*1e3:.2f}ms "
          f"step={service.live_step()}")

    if args.watch:
        print("[serve] watching", args.events or args.ckpts_dir,
              file=sys.stderr)
        service.start()
        try:
            while True:
                if promoter.poll_once():
                    prev, now = promoter.swaps[-1]
                    print(f"[serve] hot-swapped {prev} -> {now}",
                          file=sys.stderr)
                time.sleep(args.poll_interval)
        except KeyboardInterrupt:
            pass
        finally:
            service.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
