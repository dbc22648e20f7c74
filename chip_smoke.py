"""Run the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py                # all phases (one card)
    python3 chip_smoke.py --kernels-only # build + the kernel phases only
    python3 chip_smoke.py --trace        # all phases + profiler traces of
                                         # one validation, three training
                                         # steps, one LM forward and one
                                         # decode_32k decode step
    python3 chip_smoke.py --train-only   # the kernel phases, then only the
                                         # train phase (5c) on its data
    python3 chip_smoke.py --serve-only   # the kernel phases, then the main
                                         # phase (5) and the serve phase
                                         # (5d) on its checkpoints
    python3 chip_smoke.py --fleet-only   # the kernel phases, then the main
                                         # phase (5) and the fleet phase
                                         # (5e) on its checkpoints
    python3 chip_smoke.py --families-only  # the kernel phases, then the
                                           # families phase (7)
    python3 chip_smoke.py --launch-only  # the kernel phases, then the
                                         # launch phase (8); with --trace
                                         # (b) again after (a), each cell
                                         # with a profiled call
    python3 chip_smoke.py --examples-only  # the kernel phases, then the
                                           # examples phase (9)

Phases, each printing one JSON line:

  1. device   — ``nvidia-smi`` name and power limit, the torch device name,
                and the nvcc builds of the kernels from ``src/repro_torch/csrc``
                (one nvcc per source, started together); then a
                ``flash_build`` line: each flash instantiation's ptxas
                registers and spill bytes and its counts of ``HGMMA`` and
                ``HMMA`` (tensor-core) instructions from ``cuobjdump -sass``
                and whether ptxas serialised its wgmma (every bf16 and f32
                instantiation must have some, spill nothing and not be
                serialised), and ``carried_a_fragments``, the wgmma whose
                register A fragment a later instruction of their loop
                overwrites (must be 0); then a
                ``topk_build`` line: the same for the topk_mips kernels
                (``score_f32``, ``score_tc<bf16>``, ``score_tc<int8>``,
                ``select_topk``), with the warpgroup MMA count by mnemonic
                (``HGMMA``, ``IGMMA``): none may spill, and the bf16 and int8
                scoring kernels must have some; then a ``decode_build``
                line: the same for every decode instantiation
                (``decode_split_tc<d>`` at bf16, ``decode_split_f32<d,GT>``,
                ``decode_merge``) with its ``HMMA`` (``mma.sync``) count:
                every bf16 pass-1 instantiation at d >= 16 must have some
                and spill nothing.
  2. kernels  — every topk_mips kernel (f32, bf16, int8) at the main path's
                shapes (Q=256 queries, D=768, a chunk of N=1024 rows, k=100
                and 1000, a ragged chunk, the engine carry) plus edge shapes,
                exact ties from duplicated integer rows and ties exactly at
                the carry's k-th score, held against its plain PyTorch
                version on the card, and timed with CUDA events (``ms``,
                wrapper included) beside the plain version and a library
                yardstick (``torch.topk(q @ c.T)``, which the port never
                calls); ``device_ms`` is the two kernels' device time per
                call from a ``torch.profiler`` window over 20 calls (the
                union of their intervals), ``device_ms_by_kernel`` each
                kernel's own.  Then the materialized engine's call, one
                ``topk_mips`` over a whole corpus (Q=256, N=65536, D=768,
                k=100) at each dtype (``"shape": "whole_corpus"``): one
                launch per window of ``ops._windows``, held and timed as
                above, with ``wrapper_ms`` for the wrapper as the engine
                calls it.  Then the quickstart twin's call (f32, Q=60, a
                chunk of N=128 rows of D=32, k=100, with the carry;
                ``"shape": "quickstart"``), held and timed as the main
                path's.
  3. flash    — the flash-attention kernel (f32, bf16) at the LM path's shape
                (B=4, H=14, KV=2, S=T=2048, d=64, causal, on the trunk's
                strided views) and the qwen2-72b head geometry (B=1, H=64,
                KV=8, S=T=2048, d=128), plus the reference's kernel-test
                cases, held against its plain version on the card, and
                timed beside it and ``scaled_dot_product_attention`` (the
                yardstick only); the f32 rows also give ``fma_bound_ms``,
                the bound of the same two products at the f32 FMA rate.
                Keys past ``t_valid`` must change nothing, and a NaN in a
                query row or in V must come out where the plain version's
                does.
  3b. decode  — the decode-attention kernel (f32, bf16) against its plain
                version on the card at the serve path's shape (B=4, KV=2, G=7,
                d=64, cache 144, lengths 128 and 143), one qwen2-0.5b layer
                at decode_32k (B=128, 32768 keys) and at long_500k (B=1,
                524288 keys, and a 32768-key prefix of that capacity), the
                qwen2-72b geometry (B=8, KV=8, G=8, d=128, 32768 keys), the
                reference's kernel-test cases and 12 random small shapes, on
                the trunk's transposed cache views; garbage past length must
                change nothing; timed beside the plain version and
                ``scaled_dot_product_attention`` over the valid prefix.  Each
                row gives the plan (``splits``, ``keys_per_split``) and, as
                the topk rows do, ``device_ms`` and ``device_ms_by_kernel``
                (``decode_split``, and ``decode_merge`` with more than one
                split) from a profiler window over 20 calls.
  4. encoder  — the full-width dr-bert-base trunk on the card against the same
                trunk on the CPU, in f32, on a few sequences.
  5. main     — the validator CLI (``repro_torch.core.cli.main``) on two
                seeded random full-width dr-bert-base checkpoints over a
                synthetic corpus of 8192 passages, for ``--impl cuda`` at
                f32, bf16 and int8 and ``--impl torch`` at f32: empty errors,
                one ledger row per step with the reference's keys, one kernel
                launch per corpus chunk and checkpoint, and equal f32 metrics
                between the two impls.  All at the default ``--scan_window``
                8: the engine's dispatches are counted (``step`` /
                ``step_window`` calls), one chunk each under cuda, one
                window of the 8 chunks under torch; then ``--impl torch``
                at ``--scan_window`` 1 and 3 (a halving tail: 3, 3, 1, 1),
                whose TREC runs must be byte-identical to the window-8
                run's and whose metrics equal; a ``"part": "scan_window"``
                line gives each window's dispatches and ``encode_corpus_s``
                / ``total_s``.
  5b. subset  — the paper's subset and rerank path on the main phase's data:
                (a) the port's lexical baseline run (top 100, 30% of query
                tokens dropped) as a TREC run and ``repro_torch.core.
                splitter`` at depth 100 (every gold passage kept);
                (b) ``--engine materialized --impl cuda`` against streaming
                at f32, bf16 and int8, both encoding 1024 rows a batch: one
                topk_mips launch per window per checkpoint, at most 1% of the
                (step, query) top-k lists and no metric by more than 1e-4
                apart, the ledger ``timings`` of both; (c) ``--mode rerank``
                over the baseline's top 100 on streaming and on materialized
                at ``--rerank_block`` 16 and 256 (identical runs; streaming
                vs materialized held as in b); (d) ``--mode average_rank``
                (``qrel_pool``): ``AverageRank`` finite, the reference's keys;
                (e) ``--token_backing mmap`` at bf16: metrics equal to the
                memory-backed run, and a second run reuses the cache without
                touching a file; (f) ``fidelity_report`` of the subset
                ledger against the full-corpus ledger (MRR@10) over the two
                checkpoints and a third.
  5d. serve   — the retrieval serving tier (``repro_torch.serve``) on the
                main phase's data and checkpoints, all through the
                topk_mips kernels (``impl="cuda"``): (a) ``python -m
                repro_torch.launch.serve`` one-shot (f32, k=10, micro-batches
                of 8) and ``repro_torch.core.cli --serve --keep_top_k 1`` on
                a copy of the checkpoints: exit 0, one swap event, the
                served step the selector's pick and kept by GC, launches = a
                window per micro-batch plus the verify's canary (plus the
                validation's chunks); (b) per dtype (f32, bf16, int8) an
                index of the first checkpoint answering all 256 queries
                (k=100) through ``QueryService.answer`` against the main
                phase's ledger and TREC run (at most 1% of lists, 1e-4 on
                metrics) and bit-equal to ``retrieve_run(impl="cuda")`` on
                the same operands; (c) under deterministic algorithms, 8
                client threads submitting the 256 queries in a loop while
                the promoter's background loop swaps between the two
                checkpoints 3 times: nothing dropped, rejected or timed
                out, every response bit-equal to its step's precomputed
                answer, the replayed timeline equal to the swaps; latency
                p50 / p99 with and without a build running, queries per
                second, build and promote seconds, occupancy; (d) an index
                of MS MARCO passage's size (8,841,823 seeded unit rows,
                D=768, drawn on the card) at f32, int8 over it, then bf16:
                a micro-batch of 8 against ``topk_exact`` on the card (same
                ids, scores within 1e-5), 50 micro-batches through
                ``answer`` (per batch: CUDA events around
                ``ServingIndex.topk``, wall, launches = windows), the
                kernels alone (``ms``, profiler ``device_ms`` by kernel, the
                window loop's host time), the wrapper (int8: with the corpus
                quantization, also alone), the bytes bound and
                ``torch.topk(q @ c.T, 10)``.
  5e. fleet   — the validator fleet and the sharded paths on the main
                phase's data and checkpoints: (a) two ``ValidatorWorker``
                threads, each on its own CUDA stream, drain one ledger
                ``WorkQueue`` with a two-task suite (f32 and int8, both
                ``impl="cuda"``; 4 units): every unit completed once, the
                claims split, 8 topk_mips launches a unit (16 f32, 16
                int8), metrics within 1e-6 of the main phase's rows,
                ``replay`` equal to the online folds; (b) ``python -m
                repro_torch.launch.fleet --workers 2 -- python -m
                repro_torch.core.cli --worker --impl cuda ...`` on a fresh
                copy (exit 0, each step ledgered once, the main phase's
                metrics), then a victim worker SIGKILLed while it holds a
                lease and a survivor (``--lease_ttl 4``) that ticks the
                lease out, reclaims and completes it (each unit once,
                ``replay`` attributing to the survivor what it reported
                online); walls and checkpoint-to-verdict; (c) on
                ``make_mesh((2, 2), ("data", "model"), devices=[cuda:0] *
                4)``: ``impl="torch"`` f32 retrieval (``topk_sharded``)
                and rerank over the baseline's top 100
                (``rerank_sharded``) at full width, no topk_mips launch,
                at most 1% of (step, query) top-k lists and 1e-4 on
                metrics from the unsharded runs (the card encodes and
                scores its four shards' rows in one call each; a
                ``"mode": "rounding"`` line shows what a product per shard
                would move); ``impl="cuda"`` with the mesh: 8 launches a
                checkpoint; (d) serve phase d's
                8,841,823 rows in a ``ServingIndex`` over the four shards
                (1 zero pad in the last): 10 micro-batches of 8 at k=10
                with ids equal to the unsharded ``topk_exact`` on the card
                and scores within 1e-5, ms per batch (CUDA events).
  5c. train   — the trainer and the asynchronous train -> validate loop
                (paper Fig. 1) on the main phase's data: full-width
                dr-bert-base, f32, AdamW (warmup to 3e-5, temperature 0.05),
                16 queries x 2 passages a step, 240 steps, a checkpoint
                (params + AdamW state) every 80, the validator at
                ``impl="cuda"`` f32 with telemetry: (a) the first 3 steps on
                the card and on the CPU at 2 layers, losses within 1e-3
                relative; (b) async (Fig. 1b: ``validator.start()``,
                ``trainer.run()``, ``validator.stop(drain=True)``) and (c)
                sync (Fig. 1a: after each save, ``saver.wait()`` then
                ``validate_pending()``), both under
                ``torch.use_deterministic_algorithms``: every saved step
                ledgered once, the loss falls, topk_mips launched from the
                validator thread, equal metrics between the modes; step ms
                alone and with a validation in flight, walls,
                checkpoint-to-verdict, seconds in ``_save``, MRR@10; (f) the
                control plane and the snapshot hand-off on the async loop
                (``launch.train``'s ``make_handoff`` / ``make_control`` /
                ``drive``, under the same deterministic algorithms): a
                checkpoint every 40 steps handed over as a host snapshot (a
                ring of 2), early stop on MRR@10 (patience 2, min_delta 1.0:
                a plateau at the third verdict), GC to the top 2, a soup of
                the top 2 after the drain; gates: a plateau STOP written on
                the validator thread, the trainer halted before step 240,
                GC deleted only validated steps, the soup committed and
                ledgered, the snapshot-scored rows equal to a durable
                re-validation in a fresh ledger (metrics, top-k lists),
                replay byte-identical to the online decisions, the ring
                empty at the end; checkpoint-to-verdict with hand-off, the
                peak bytes the ring held, the wall; (d) the last checkpoint
                of (b) restored through the port leaf for leaf; (e)
                ``python -m repro_torch.launch.train`` on its smoke config;
                a ``"phase": "subset", "part": "f", "weights": "trained"``
                line: fidelity of the splitter's subset on the trained
                checkpoints.
  6. lm       — full-width qwen2-0.5b (24 layers, random weights from a seed;
                ``--trace`` also traces one f32 and one bf16 forward):
                (a) ``lm_loss`` and ``forward`` on 4 x 2048 tokens with
                ``attn_impl`` "cuda" (24 flash launches per forward) and
                "torch" (none), at f32 and bf16, against each other; each
                entry point's first call is checked and counted, the next
                five are timed (CUDA events: median, least, most);
                (b) the card against the CPU at 2 layers, S=256, f32;
                (c) ``lm_demo.serve_batch`` (prefill + greedy decode, batch 4,
                prompt 128, gen 16) for both impls: under "cuda" 24 decode
                launches per decode step and no flash launch, tokens/s
                (median of three calls after a warm-up); at f32 equal greedy
                tokens, teacher-forced decode-step logits of the two impls
                and the last step against the no-cache flash forward within
                1e-3, prefill against the flash forward within 1e-3;
                (d) one bf16 ``decode_step`` at decode_32k (batch 128, a
                32768-token cache of seeded random K/V at a real prefill's
                scale) for both impls: 24 decode launches, logits row cosine,
                step time (CUDA events, five warm steps), peak memory;
                (e) the same step on qwen2-72b at full width, 2 of its 80
                layers, batch 16, a 32768-token cache.
  7. families — the other model families at full width, weights drawn on
                the card from a seed at each leaf's dtype (an MoE router
                in f32): (a) deepseek-v2-lite-16b at full depth (27
                layers, bf16 parameters): ``lm_loss`` and ``forward`` on 4
                x 2048 tokens under "cuda" and "torch" (MLA takes the
                chunked path under both: equal bits, no kernel launch),
                each first call checked and counted, five more timed (CUDA
                events); ``serve_batch`` (batch 4, prompt 128, gen 16,
                tokens/s, equal tokens, no launch) and its device idle
                share; then 2 layers (one dense, one MoE) in f32 against
                the CPU (S=256) and, with capacity factor E (no drops), the
                teacher-forced absorbed decode against the no-cache forward
                (1e-3); (b) arctic-480b, 2 of its 35 layers at full width
                in bf16 (the 35 would need ~960 GB): the same pair on 1 x
                2048 tokens, 2 flash launches a forward (H=56, KV=8, G=7,
                d=128), the logits of the impls by row cosine (median and
                a share of the rows: a near tie of router probabilities
                routes a token differently under either rounding);
                ``serve_batch`` with 2 decode launches a step and no flash
                launch; at f32 compute and capacity factor E, the decode
                kernel's teacher-forced steps against the flash forward
                (1e-3); peak memory; (c) bert4rec, sasrec, mind and deepfm
                at their full configs, f32: ``serve_fn`` at serve_p99
                (batch 512, 1000 candidates), ``loss_fn`` at batch 512
                (forward only) and, but for deepfm, retrieval at
                retrieval_cand (1 user, 10^6 candidates, top 100 by
                ``topk_exact``, ids equal), each against the CPU; (d)
                graphcast at its full config on full_graph_sm (2708 nodes,
                10556 edges, 1433 features) and on one minibatch_lg
                subgraph (1024 seeds, fanout (15, 10), 602 features) that
                the port's sampler draws from a synthetic graph of 232,965
                nodes with 32 out-edges each (the published 114.6 M cut to
                what the host sorts in seconds): ``forward`` and ``loss_fn``
                at f32 and bf16 on the card, the card against the CPU at
                f32 (full depth on full_graph_sm, 2 layers on the
                minibatch); ogb_products is not run (its edge latents alone
                are 63 GB in bf16); (e) first, MoE routing ties:
                ``_moe_block`` at arctic-480b's routing geometry (128
                experts, top 2, d_model 7168, experts cut to 64 wide), 2 x
                192 tokens, f32 and bf16, with a zero router and with pairs
                of equal router columns: the experts chosen equal the
                CPU's, [0, 1] for every token under the zero router (the
                lower expert first on equal probabilities, as
                ``jax.lax.top_k``).
  8. launch   — the launch steps (``repro_torch.launch.steps`` /
                ``dryrun`` / ``analysis``): (a) ``python -m
                repro_torch.launch.dryrun --all --skip-multipod --device
                cuda`` (one process per cell, up to 8 at a time, host
                work only, run while (b) times the card): each of the 43
                cells of ``steps.all_cells()`` built on the 16 x 16
                production mesh and its full variant and cost variants run
                on meta tensors; every record ``ok`` (the line gives each
                cell's roofline bottleneck and step time, GiB a device and
                the seconds of its meta run); (b) the paper's three
                dr-bert-base cells built on ``make_validator_mesh(1)``
                (one ``cuda:0``) and run at full shape on the card with
                their arguments drawn from a seed: ``train_contrastive``
                (256 queries x 2 passages, one AdamW step), ``encode_corpus``
                (4096 x 128 tokens), ``retrieve`` (6980 queries over
                8,841,823 unit rows x 768, f32, k = 1000); per cell three
                warm-ups and the median of five calls (CUDA events), the
                peak memory, the port's roofline step time of the same cell
                at one device and model flops per second as a share of the
                bf16 peak (retrieve: also of the f32 peak), no kernel
                launch, and a gate: encode_corpus's first 64 rows against
                the port on the CPU (row cosine >= 0.999), retrieve's
                top-1000 ids of the first 64 queries equal to
                ``torch.topk`` of the same products block by block,
                train_contrastive's loss equal to a separate
                ``contrastive_loss`` within 1e-5 relative and every updated
                leaf finite and changed.
  9. examples — each of the eleven ``examples/<name>_torch.py`` twins in
                this process on the card at its original's default sizes
                (quickstart, train_with_control, lazy_handoff,
                async_vs_sync, subset_fidelity, multi_task_validation,
                serve_live, fleet_validation, distributed_validation,
                observability, recsys_asyncval), its own asserts live: one
                line each with its seconds and what its original prints;
                then the quickstart again with ``impl="cuda"``: one
                topk_mips launch per corpus chunk and checkpoint, metrics
                within 1e-6 of the torch route's.

Kernel launches are counted only while a path runs (the main path for
topk_mips, also read over each run of the train phase, the subset phase's
materialized runs for its whole-corpus rows, the serve phase's 50 timed
micro-batches at MS MARCO's size for its ``_serve`` rows, the fleet
phase's in-process fleet (a) for its ``_fleet`` rows,
the LM phase's ``lm_loss`` for flash attention, its ``serve_batch`` calls
for decode attention: the three timed bf16 calls and the f32 one; the
families phase's arctic ``lm_loss`` for its ``_arctic`` flash bf16 row,
its f32 forward for the f32 one, its three timed bf16 ``serve_batch``
calls and its f32 teacher-forced steps for the decode rows; the examples
phase's ``impl="cuda"`` quickstart for the ``_quickstart`` row, whose
times are the kernel phase's ``"shape": "quickstart"`` row: 60 queries, a
chunk of 128 rows of 32 dims, k = 100), with every count set to 0 just
before it.  Then a
``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``.
Any failed check raises, so the script exits non-zero before that line.  It
needs a CUDA device and the checkout's ``src/`` beside it; scratch files go
to ``build/chip_smoke/``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# One H100 SXM, NVIDIA's data sheet (dense): HBM rate and peak rates by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12,
              # TF32 on the tensor cores: the f32 flash kernel's products
              "tf32": 495e12}
ELEM_BYTES = {"f32": 4, "bf16": 2, "int8": 1}
# the kernel phase's whole-corpus topk_mips call (the materialized engine's)
WHOLE_CORPUS = {"Q": 256, "N": 65536, "D": 768, "k": 100}
# (Q, N, D, k, n_valid) of the quickstart twin's topk_mips call: 60 queries,
# corpus chunks of 128 rows of the toy retriever's 32 dims, k = 100
QUICKSTART_SHAPE = (60, 128, 32, 100, 128)
REPLACES = {"f32": "src/repro/kernels/topk_mips/kernel.py:135",
            "bf16": "src/repro/kernels/topk_mips/kernel.py:135",
            "int8": "src/repro/kernels/topk_mips/kernel.py:176"}
SOURCE = "src/repro_torch/csrc/topk_mips.cu"
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:85"
DECODE_SOURCE = "src/repro_torch/csrc/decode_attention.cu"
DECODE_REPLACES = "src/repro/kernels/decode_attention/kernel.py:78"
# attention kernels (flash, decode) vs plain on the card.  f32: sums in
# another order, |delta| <= abs.
# bf16: the kernel rounds its f32 result once, so it lies within half a bf16
# ulp (2**-8 of the value) of the plain version's f32 result before the
# cast, plus abs for the f32 sums in another order: elementwise
# |kernel - plain_f32| <= rel * |plain_f32| + abs
ATTN_TOL = {"f32": {"abs": 1e-4}, "bf16": {"rel": 2.0 ** -8, "abs": 1e-5}}
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
LEDGER_KEYS = {"step", "task", "metrics", "timings", "subset_size", "engine",
               "score_dtype"}
TOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def compare(dt, got, want, exact_ties: bool = False) -> float:
    """Kernel (got) vs plain (want) (scores, indices) on the card; returns
    the largest score difference."""
    gs, gi = got
    ws, wi = want
    check(gs.shape == ws.shape and gi.shape == wi.shape,
          f"{dt}: shapes {tuple(gs.shape)} vs {tuple(ws.shape)}")
    check(bool(torch.isfinite(gs).all()), f"{dt}: non-finite kernel scores")
    if dt == "int8" or exact_ties:
        check(torch.equal(gs, ws), f"{dt}: scores differ from the plain "
              f"version (max {float((gs - ws).abs().max()):.3g})")
        check(torch.equal(gi, wi), f"{dt}: indices differ")
        return 0.0
    err = float((gs - ws).abs().max()) if gs.numel() else 0.0
    check(torch.allclose(gs, ws, rtol=TOL, atol=TOL),
          f"{dt}: scores differ by {err:.3g} (tolerance {TOL})")
    # indices must agree wherever the neighbouring scores are apart
    gap = torch.full_like(ws, float("inf"))
    d = (ws[:, 1:] - ws[:, :-1]).abs()
    gap[:, 1:] = torch.minimum(gap[:, 1:], d)
    gap[:, :-1] = torch.minimum(gap[:, :-1], d)
    sure = gap > TOL
    check(torch.equal(gi[sure], wi[sure]), f"{dt}: indices differ where "
          "the scores are more than the tolerance apart")
    return err


def plain_inputs(dt, q, c):
    from repro_torch.kernels.topk_mips.ops import quantize_int8
    if dt == "f32":
        return q, c, None, None
    if dt == "bf16":
        return q.to(torch.bfloat16), c.to(torch.bfloat16), None, None
    qv, qs = quantize_int8(q)
    cv, cs = quantize_int8(c)
    return qv, cv, qs.reshape(-1).contiguous(), cs.reshape(-1).contiguous()


def plain_chunk(dt, qk, ck, qs, cs, run_s, run_i, base, n_valid):
    """The plain version of one engine step on the kernel's own inputs:
    scores, mask, stable-sort merge with the carry."""
    from repro_torch.kernels.topk_mips import ref
    if dt == "int8":
        s = ref.int8_scores_ref(qk, ck, qs, cs)
    else:
        s = ref.scores_ref(qk, ck, "f32")          # bf16 values, f32 sums
    s = s[:, :n_valid]
    idx = torch.arange(n_valid, dtype=torch.int32, device=s.device)
    return ref.merge_carry_ref(run_s, run_i, s,
                               idx.expand(s.shape[0], -1), base,
                               run_s.shape[1])


def library_call(dt, qk, ck, qs, cs, k):
    """One PyTorch top-k over a library product — the yardstick only."""
    if dt == "int8":
        raw = torch._int_mm(qk, ck.t())          # column-major, no copy
        return torch.topk(raw.float() * qs[:, None] * cs[None, :], k)
    return torch.topk((qk @ ck.T).float(), k)


def kernel_phase(device):
    from repro_torch.kernels.topk_mips import ops, ref
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape):
        # unit rows, as the encoder hands them to the kernels
        x = torch.randn(*shape, generator=gen)
        return (x / x.norm(dim=-1, keepdim=True)).to(device)

    rows = {}
    Q, N, D = 256, 1024, 768
    for dt in ("f32", "bf16", "int8"):
        # standalone top-k at edge shapes, a window-crossing corpus, and
        # exact ties from duplicated integer-valued rows
        cases = [(4, 300, 17, 10, None), (33, 1000, 96, 128, None),
                 (7, 50, 64, 60, None), (Q, N, D, 1000, 777),
                 (16, 20000, 64, 1000, None)]
        for (cq, cn, cd, k, nv) in cases:
            q, c = rand(cq, cd), rand(cn, cd)
            got = ops.topk_mips(q, c, k=k, n_valid=nv, score_dtype=dt)
            want = ref.topk_mips_ref(q, c, k=k, n_valid=nv, score_dtype=dt)
            torch.cuda.synchronize()
            compare(dt, got, want)
        q = torch.randint(-3, 4, (8, 64), generator=gen).float().to(device)
        c = torch.randint(-3, 4, (40, 64), generator=gen).float()
        c = c.repeat(8, 1).to(device)                  # every row 8 times
        compare(dt, ops.topk_mips(q, c, k=50, score_dtype=dt),
                ref.topk_mips_ref(q, c, k=50, score_dtype=dt),
                exact_ties=True)
        # ties at the threshold: a full carry from one integer chunk, then a
        # chunk holding every one of its rows again (so each row's k-th
        # carry score recurs exactly) among new ones; the carry must win
        c1 = torch.randint(-3, 4, (300, 64), generator=gen).float()
        c2 = torch.cat([c1[torch.randperm(300, generator=gen)],
                        torch.randint(-3, 4, (200, 64), generator=gen)
                        .float()]).to(device)
        c1 = c1.to(device)
        run = ops.topk_mips_chunk(
            q, c1, torch.full((8, 50), float("-inf"), device=device),
            torch.zeros((8, 50), dtype=torch.int32, device=device), base=0,
            score_dtype=dt)
        qk, ck, qs, cs = plain_inputs(dt, q, c2)
        compare(dt, ops.topk_mips_chunk(q, c2, *run, base=300,
                                        score_dtype=dt),
                plain_chunk(dt, qk, ck, qs, cs, *run, 300, 500),
                exact_ties=True)

        # the main path's call: one chunk folded into the engine carry
        for k in (100, 1000):
            for n_valid in (N, 700):
                row = chunk_row(device, rand, dt, Q, N, D, k, n_valid)
                emit(row)
                if k == 100 and n_valid == N:
                    rows[dt] = row
    whole = whole_corpus_rows(device, rand)
    # the quickstart twin's call (phase 9, impl="cuda"): the toy retriever's
    # 32-wide rows, its 60 queries, a chunk of 128, k=100, with a carry
    quick = chunk_row(device, rand, "f32", *QUICKSTART_SHAPE)
    quick["shape"] = "quickstart"
    emit(quick)
    emit({"phase": "kernels", "ok": True,
          "checked_launches": dict(ops.launches),
          "seconds": time.perf_counter() - t_phase})
    return rows, whole, quick


def chunk_row(device, rand, dt, Q, N, D, k, n_valid):
    """One engine step through the kernel (a chunk of N rows, ``n_valid``
    of them real, folded into a full (Q, k) carry) held against its plain
    version on the card and timed beside it and the library yardstick:
    the kernel phase's row."""
    from repro_torch.kernels.topk_mips import ops
    q, c = rand(Q, D), rand(N, D)
    run_s, run_i = ops.topk_mips_chunk(
        q, rand(N, D), torch.full((Q, k), float("-inf"), device=device),
        torch.zeros((Q, k), dtype=torch.int32, device=device),
        base=0, score_dtype=dt)
    qk, ck, qs, cs = plain_inputs(dt, q, c)
    base = 5 * N

    def kernel():
        return ops._topk_cuda(dt, qk, ck, qs, cs, k_target=k,
                              n_valid=n_valid, carry=(run_s, run_i),
                              base=base)

    def plain():
        return plain_chunk(dt, qk, ck, qs, cs, run_s, run_i, base, n_valid)

    got = ops.topk_mips_chunk(q, c, run_s, run_i, base=base,
                              n_valid=n_valid, score_dtype=dt)
    torch.cuda.synchronize()
    err = compare(dt, got, plain())
    compare(dt, kernel(), got, exact_ties=True)
    ms, plain_ms = cuda_time_ms(kernel), cuda_time_ms(plain)
    dev_ms, by_kernel = device_ms(f"topk_{dt}_{Q}_{N}_{D}_{k}_{n_valid}",
                                  kernel, TOPK_KERNELS)
    library_ms = cuda_time_ms(lambda: library_call(dt, qk, ck, qs, cs, k))
    nbytes = (Q + N) * D * ELEM_BYTES[dt] + 4 * Q * k * 4
    if dt == "int8":
        nbytes += (Q + N) * 4
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 2 * Q * n_valid * D / PEAK_OPS_S[dt] * 1e3
    return {"phase": "kernels", "variant": dt, "Q": Q, "N": N,
            "n_valid": n_valid, "D": D, "k": k, "max_abs_err": err,
            "ms": ms, "device_ms": dev_ms, "device_ms_by_kernel": by_kernel,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def whole_corpus_rows(device, rand):
    """The materialized engine's call: one ``topk_mips`` over a whole
    corpus (Q=256, N=65536, D=768, k=100), which the wrapper cuts into
    windows folded through a carry.  Held against the plain version; ``ms``
    and ``device_ms`` time the windows' launches on the kernel's inputs
    (cast or quantized once, as the other rows), ``wrapper_ms`` the wrapper
    as the engine calls it (bf16: a bf16-resident corpus; int8: f32 inputs
    quantized in the call)."""
    from repro_torch.kernels.topk_mips import ops, ref
    Q, N, D, k = WHOLE_CORPUS["Q"], WHOLE_CORPUS["N"], WHOLE_CORPUS["D"], \
        WHOLE_CORPUS["k"]
    lib = ops._lib(device)
    windows = len(ops._windows(N, k, 0, lib.cols, lib.max_cand))
    rows = {}
    q, c = rand(Q, D), rand(N, D)
    for dt in ("f32", "bf16", "int8"):
        resident = c.to(torch.bfloat16) if dt == "bf16" else c
        qk, ck, qs, cs = plain_inputs(dt, q, c)
        ops.reset_launches()
        got = ops.topk_mips(q, resident, k=k, score_dtype=dt)
        torch.cuda.synchronize()
        launches = ops.launches[dt]
        check(launches == windows, f"whole-corpus {dt}: {launches} launches, "
              f"{windows} windows")
        err = compare(dt, got, ref.topk_mips_ref(q, c, k=k, score_dtype=dt))

        def kernel():
            return ops._topk_cuda(dt, qk, ck, qs, cs, k_target=k, n_valid=N)

        compare(dt, kernel(), got, exact_ties=True)
        ms = cuda_time_ms(kernel)
        dev_ms, by_kernel = device_ms(f"topk_whole_{dt}", kernel,
                                      TOPK_KERNELS)
        wrapper_ms = cuda_time_ms(
            lambda: ops.topk_mips(q, resident, k=k, score_dtype=dt))
        plain_ms = cuda_time_ms(
            lambda: ref.topk_mips_ref(q, c, k=k, score_dtype=dt), iters=5)
        library_ms = cuda_time_ms(
            lambda: library_call(dt, qk, ck, qs, cs, k))
        nbytes = (Q + N) * D * ELEM_BYTES[dt] + 2 * Q * k * 4
        if dt == "int8":
            nbytes += (Q + N) * 4
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = 2 * Q * N * D / PEAK_OPS_S[dt] * 1e3
        row = {"phase": "kernels", "shape": "whole_corpus", "variant": dt,
               "Q": Q, "N": N, "D": D, "k": k, "windows": windows,
               "launches_per_call": launches, "max_abs_err": err, "ms": ms,
               "device_ms": dev_ms, "device_ms_by_kernel": by_kernel,
               "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        emit(row)
        rows[dt] = row
    return rows


# ---------------------------------------------------------------------------
# phase 3: flash attention against its plain version
# ---------------------------------------------------------------------------

# the LM path's shape: qwen2-0.5b heads, batch 4 x 2048 tokens, causal
FLASH_PATH = (4, 14, 2, 2048, 2048, 64, True)
# a second timed row: qwen2-72b heads (d=128), one sequence of 2048
FLASH_D128 = (1, 64, 8, 2048, 2048, 128, True)
# arctic-480b's heads (56 over 8 KV heads, G=7, d=128), as the families
# phase's forward gives them: one sequence of 2048
FLASH_ARCTIC = (1, 56, 8, 2048, 2048, 128, True)
# the cases of tests/test_kernels.py (flash_attention_matches_ref)
FLASH_CASES = [(2, 4, 2, 64, 64, 32, True), (1, 8, 8, 33, 57, 64, False),
               (2, 2, 1, 128, 256, 128, True), (1, 14, 2, 40, 40, 64, True)]


def flash_bound_ms(dt, B, H, KV, S, T, d, causal, t_valid, fma=False):
    """Least time for the work: each input read once and the output written
    once, against the operations on the pairs the mask leaves.  Each
    product (q . k or p . v) is 2 * pairs * d FLOP per head.  At bf16 the
    kernel runs three bf16 tensor-core products (q . k, p_hi . v, p_lo . v:
    p split in two bf16 halves so it keeps f32 precision); at f32 six TF32
    tensor-core products (q . k and p . v each as a_hi b_hi + a_hi b_lo +
    a_lo b_hi, the operands split so the products keep ~2**-22 relative
    precision).  ``fma``: instead the two products at the f32 FMA rate, the
    bound of a kernel without tensor cores."""
    nbytes = (2 * B * H * S * d + 2 * B * KV * T * d) * ELEM_BYTES[dt]
    if causal:
        pairs = sum(min(i + 1, t_valid) for i in range(S))
    else:
        pairs = S * t_valid
    flop = 2 * B * H * pairs * d
    if fma:
        t_ops = 2 * flop / PEAK_OPS_S["f32"]
    elif dt == "bf16":
        t_ops = 3 * flop / PEAK_OPS_S["bf16"]
    else:
        t_ops = 6 * flop / PEAK_OPS_S["tf32"]
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def plain_compare(name, got, plain, *inputs):
    """A kernel's output ``got`` against ``plain(*inputs)``, its plain
    version on the same inputs, within ``ATTN_TOL``.  Returns max |kernel
    - plain| (the plain version in the inputs' dtype) and, at bf16, the
    largest excess of |kernel - plain_f32| over half a bf16 ulp, where
    plain_f32 is the plain version on the inputs widened to f32 (None at
    f32)."""
    want = plain(*inputs)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
          f"{want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    if not got.numel():
        return 0.0, None
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.float32:
        tol = ATTN_TOL["f32"]["abs"]
        check(err <= tol, f"{name}: max |kernel - plain| {err:.3g} > {tol}")
        return err, None
    tol = ATTN_TOL["bf16"]
    want32 = plain(*(x.float() for x in inputs))
    excess = float(((got.float() - want32).abs()
                    - tol["rel"] * want32.abs()).max())
    check(excess <= tol["abs"], f"{name}: |kernel - plain_f32| exceeds "
          f"{tol['rel']:.3g} * |plain_f32| by {excess:.3g} > {tol['abs']}")
    return err, excess


def flash_kernel_phase(device):
    from repro_torch.kernels.flash_attention import ops, ref
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cpu").manual_seed(1)

    def rand(*shape, dt="f32"):
        return torch.randn(*shape, generator=gen).to(device, TORCH_DT[dt])

    def inputs(B, H, KV, S, T, d, dt):
        return rand(B, H, S, d, dt=dt), rand(B, KV, T, d, dt=dt), \
            rand(B, KV, T, d, dt=dt)

    rows, arctic = {}, {}
    rng = np.random.default_rng(2)
    # property-style random shapes, as tests/test_kernels.py draws them
    drawn = []
    for _ in range(12):
        B, H = int(rng.integers(1, 4)), int(rng.integers(1, 5))
        S, T = int(rng.integers(1, 65)), int(rng.integers(1, 65))
        causal = bool(rng.integers(0, 2))
        drawn.append((B, H, H, S, max(S, T) if causal else T,
                      int(rng.choice([8, 16, 32, 64])), causal))
    for dt in ("f32", "bf16"):
        errs, excesses = [], []

        def gate(name, got, q, k, v, **kw):
            err, excess = plain_compare(
                f"flash {dt} {name}", got,
                lambda *x: ref.flash_attention_ref(*x, **kw), q, k, v)
            errs.append(err)
            excesses.append(excess)
            return err

        for (B, H, KV, S, T, d, causal) in FLASH_CASES + drawn:
            q, k, v = inputs(B, H, KV, S, T, d, dt)
            gate((B, H, KV, S, T, d, causal),
                 ops.flash_attention(q, k, v, causal=causal), q, k, v,
                 causal=causal)
        # t_valid < T: garbage past it changes nothing
        q, k, v = inputs(1, 2, 2, 16, 64, 32, dt)
        o1 = ops.flash_attention(q, k, v, t_valid=40)
        k2, v2 = k.clone(), v.clone()
        k2[:, :, 40:], v2[:, :, 40:] = 1e3, -1e3
        o2 = ops.flash_attention(q, k2, v2, t_valid=40)
        check(torch.equal(o1, o2), f"flash {dt}: keys past t_valid leak")
        gate("t_valid", o1, q, k, v, causal=False, t_valid=40)
        # a NaN in a query row, or in V at key 0 (which every causal row
        # attends), comes out where the plain version's does: the card's
        # own NaN (all mantissa bits set), which the f32 split must keep
        int_view, nan_bits = {"f32": (torch.int32, 0x7FFFFFFF),
                              "bf16": (torch.int16, 0x7FFF)}[dt]
        for where, at in (("q", (0, 1, 150, 7)), ("v", (0, 0, 0, 7))):
            q, k, v = inputs(1, 2, 1, 200, 200, 64, dt)
            (q if where == "q" else v).view(int_view)[at] = nan_bits
            got = ops.flash_attention(q, k, v, causal=True)
            nan_want = torch.isnan(
                ref.flash_attention_ref(q, k, v, causal=True))
            check(bool(nan_want.any())
                  and torch.equal(torch.isnan(got), nan_want),
                  f"flash {dt}: a NaN in {where} comes out elsewhere than "
                  f"in the plain version")

        # the LM path and the d=128 row: transposed views of (B, S, H, d),
        # as the trunk passes them
        for name, shape in [("path", FLASH_PATH),
                            ("qwen2_72b_heads", FLASH_D128),
                            ("arctic_heads", FLASH_ARCTIC)]:
            B, H, KV, S, T, d, causal = shape
            q = rand(B, S, H, d, dt=dt).transpose(1, 2)
            k = rand(B, T, KV, d, dt=dt).transpose(1, 2)
            v = rand(B, T, KV, d, dt=dt).transpose(1, 2)

            def kernel():
                return ops.flash_attention(q, k, v, causal=causal)

            def plain():
                return ref.flash_attention_ref(q, k, v, causal=causal)

            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)

            got = kernel()
            check(got.stride() == q.stride(), f"flash {dt}: output strides "
                  f"{got.stride()} differ from q's {q.stride()}")
            err = gate(name, got, q, k, v, causal=causal)
            lib_err = float((library().float() - got.float()).abs().max())
            ms, plain_ms = cuda_time_ms(kernel), cuda_time_ms(plain, iters=5)
            library_ms = cuda_time_ms(library)
            bound_ms, bound_by = flash_bound_ms(dt, B, H, KV, S, T, d,
                                                causal, T)
            row = {"phase": "flash", "variant": dt, "shape": name, "B": B,
                   "H": H, "KV": KV, "S": S, "T": T, "d": d,
                   "causal": causal, "max_abs_err": err,
                   "tolerance": ATTN_TOL[dt], "worst_edge_err": max(errs),
                   "worst_excess_over_half_ulp": None if dt == "f32"
                   else max(excesses),
                   "library_max_abs_diff": lib_err,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            if dt == "f32":
                row["fma_bound_ms"] = flash_bound_ms(
                    dt, B, H, KV, S, T, d, causal, T, fma=True)[0]
            emit(row)
            if name == "path":
                rows[dt] = row
            elif name == "arctic_heads":
                arctic[dt] = row
            del q, k, v, got
    emit({"phase": "flash", "ok": True,
          "checked_launches": dict(ops.launches),
          "seconds": time.perf_counter() - t_phase})
    return rows, arctic


# ---------------------------------------------------------------------------
# phase 3b: decode attention against its plain version
# ---------------------------------------------------------------------------

# (name, B, KV, G, d, T capacity, length): the serve path (qwen2-0.5b heads,
# batch 4, prompt 128 + gen 16), one layer of qwen2-0.5b at decode_32k and
# at long_500k (full, and the kernel docstring's 32k prefix), and the
# qwen2-72b / deepseek-67b attention geometry, and arctic-480b's serve path
# (G=7 at d=128, the families phase's serve_batch); all read the trunk's
# transposed (B, T, KV, d) cache views
DECODE_SHAPES = [("serve", 4, 2, 7, 64, 144, 128),
                 ("serve", 4, 2, 7, 64, 144, 143),
                 ("decode_32k", 128, 2, 7, 64, 32768, 32768),
                 ("long_500k", 1, 2, 7, 64, 524288, 524288),
                 ("long_500k_prefix_32k", 1, 2, 7, 64, 524288, 32768),
                 ("qwen2_72b", 8, 8, 8, 128, 32768, 32768),
                 ("arctic_serve", 4, 8, 7, 128, 144, 128),
                 ("arctic_serve", 4, 8, 7, 128, 144, 143)]
# the shapes of the kernels line: the decode_32k layer, and arctic's
# serve_batch at its last step
DECODE_MAIN = "decode_32k"
DECODE_ARCTIC = ("arctic_serve", 143)
# names in the profiler's kernel records: pass 1, and pass 2 when the plan
# has more than one split
DECODE_KERNELS = ("decode_split", "decode_merge")
# the cases of tests/test_kernels.py (decode_attention_matches_ref):
# (B, KV, G, T, d, length)
DECODE_CASES = [(2, 2, 4, 256, 64, 100), (1, 8, 1, 512, 128, 512),
                (3, 1, 7, 300, 32, 1), (1, 8, 8, 1024, 128, 700)]


def decode_bound_ms(dt, B, KV, G, d, length):
    """Least time for the work: q, the valid K and V prefix and the output
    once, against 2 * B * KV * G * length * d FLOP for each product (q . k
    of bf16 values on bf16 tensor cores, p . v with f32 p at the f32
    rate: the decode kernel keeps p in f32)."""
    nbytes = (2 * B * KV * G * d + 2 * B * KV * length * d) * ELEM_BYTES[dt]
    flop = 2 * B * KV * G * length * d
    t_ops = flop / PEAK_OPS_S[dt] + flop / PEAK_OPS_S["f32"]
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def decode_kernel_phase(device):
    from repro_torch.kernels.decode_attention import ops, ref
    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(3)

    def rand(*shape, dt="f32"):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=TORCH_DT[dt])

    def cache_views(B, KV, T, d, dt):
        """k, v as the trunk passes them: (B, T, KV, d) -> (B, KV, T, d)."""
        return (rand(B, T, KV, d, dt=dt).transpose(1, 2),
                rand(B, T, KV, d, dt=dt).transpose(1, 2))

    rng = np.random.default_rng(4)
    drawn = []
    for _ in range(12):
        T = int(rng.integers(1, 300))
        drawn.append((int(rng.integers(1, 4)), int(rng.integers(1, 5)),
                      int(rng.integers(1, 17)), T,
                      int(rng.choice(ops.HEAD_DIMS)),
                      int(rng.integers(1, T + 1))))
    rows, arctic = {}, {}
    for dt in ("f32", "bf16"):
        errs, excesses = [], []

        def gate(name, got, length, q, k, v):
            err, excess = plain_compare(
                f"decode {dt} {name}", got,
                lambda *x: ref.decode_attention_ref(length, *x), q, k, v)
            errs.append(err)
            excesses.append(excess)
            return err, excess

        for (B, KV, G, T, d, L) in DECODE_CASES + drawn:
            q = rand(B, KV, G, d, dt=dt)
            k, v = rand(B, KV, T, d, dt=dt), rand(B, KV, T, d, dt=dt)
            gate((B, KV, G, T, d, L), ops.decode_attention(q, k, v, L),
                 L, q, k, v)
            k, v = cache_views(B, KV, T, d, dt)
            gate((B, KV, G, T, d, L, "views"),
                 ops.decode_attention(q, k, v, L), L, q, k, v)

        for (name, B, KV, G, d, T, L) in DECODE_SHAPES:
            q = rand(B, KV, G, d, dt=dt)
            k, v = cache_views(B, KV, T, d, dt)

            def kernel():
                return ops.decode_attention(q, k, v, L)

            def plain():
                return ref.decode_attention_ref(L, q, k, v)

            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    q.reshape(B, KV * G, 1, d), k[:, :, :L], v[:, :, :L],
                    enable_gqa=True)

            got = kernel()
            splits, keys_per_split = ops.split_plan(q, L)
            err, excess = gate(name, got, L, q, k, v)
            if L < T:
                # garbage past length changes nothing, bit for bit
                k2, v2 = k.clone(), v.clone()
                k2[:, :, L:], v2[:, :, L:] = 1e4, -1e4
                check(torch.equal(ops.decode_attention(q, k2, v2, L), got),
                      f"decode {dt} {name}: keys past length leak")
                del k2, v2
            lib_err = float((library().reshape(got.shape).float()
                             - got.float()).abs().max())
            ms = cuda_time_ms(kernel)
            dev_ms, by_kernel = device_ms(f"decode_{dt}_{name}_{L}", kernel,
                                          DECODE_KERNELS)
            plain_ms = cuda_time_ms(plain, iters=5)
            library_ms = cuda_time_ms(library)
            bound_ms, bound_by = decode_bound_ms(dt, B, KV, G, d, L)
            row = {"phase": "decode", "variant": dt, "shape": name, "B": B,
                   "KV": KV, "G": G, "d": d, "T": T, "length": L,
                   "splits": splits, "keys_per_split": keys_per_split,
                   "max_abs_err": err, "tolerance": ATTN_TOL[dt],
                   "excess_over_half_ulp": excess,
                   "library_max_abs_diff": lib_err,
                   "ms": ms, "device_ms": dev_ms,
                   "device_ms_by_kernel": by_kernel,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_share": bound_ms / ms}
            emit(row)
            if name == DECODE_MAIN:
                rows[dt] = row
            elif (name, L) == DECODE_ARCTIC:
                arctic[dt] = row
            del q, k, v, got
            torch.cuda.empty_cache()
        emit({"phase": "decode", "variant": dt, "checked": len(errs),
              "worst_err": max(errs),
              "worst_excess_over_half_ulp": None if dt == "f32"
              else max(excesses)})
    emit({"phase": "decode", "ok": True,
          "checked_launches": dict(ops.launches),
          "seconds": time.perf_counter() - t_phase})
    return rows, arctic


# ---------------------------------------------------------------------------
# phase 4: the full-width encoder on the card against the CPU
# ---------------------------------------------------------------------------


def encoder_phase(device):
    import dataclasses

    from repro_torch.configs import dr_bert_base
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(dr_bert_base.full_config(), n_layers=2,
                              compute_dtype=torch.float32)
    tree = tfm.init_numpy(cfg, 7)
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, (4, 64))
                            .astype(np.int32))
    mask = torch.zeros((4, 64), dtype=torch.bool)
    for i, n in enumerate((64, 40, 17, 3)):
        mask[i, :n] = True
    cpu = tfm.encode(tfm.params_from_numpy(tree), cfg, toks, mask, "cls")
    with torch.inference_mode():
        gpu = tfm.encode(tfm.params_from_numpy(tree, device), cfg,
                         toks.to(device), mask.to(device), "cls").cpu()
    err = float((gpu - cpu).abs().max())
    check(bool(torch.isfinite(gpu).all()) and err < 1e-4,
          f"encoder on the card differs from the CPU by {err:.3g}")
    emit({"phase": "encoder", "ok": True, "max_abs_err": err,
          "tolerance": 1e-4, "layers": cfg.n_layers})


# ---------------------------------------------------------------------------
# phase 5: the validator CLI on full-width checkpoints
# ---------------------------------------------------------------------------


WORK = os.path.join(ROOT, "build", "chip_smoke")
N_DOCS, N_QUERIES = 8192, 256


def write_dataset():
    """The main phase's synthetic dataset (8192 passages x 128 tokens, 256
    queries of 32) as the CLI's files under ``WORK``, made anew."""
    from repro_torch.configs import dr_bert_base
    from repro_torch.data import corpus as corpus_lib
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(os.path.join(WORK, "corpus"))
    ds = corpus_lib.synthetic_retrieval_dataset(
        0, n_passages=N_DOCS, n_queries=N_QUERIES,
        vocab=dr_bert_base.full_config().vocab_size, p_len=128, q_len=32)
    corpus_lib.write_jsonl(os.path.join(WORK, "corpus", "c.jsonl"),
                           ds.corpus)
    corpus_lib.write_jsonl(os.path.join(WORK, "q.jsonl"), ds.queries)
    with open(os.path.join(WORK, "qrels.txt"), "w") as f:
        for qid, docs in ds.qrels.items():
            for did, g in docs.items():
                f.write(f"{qid} 0 {did} {g}\n")
    return ds


def main_phase(device, ds):
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import dr_bert_base
    from repro_torch.core import cli
    from repro_torch.core import engine as engine_lib
    from repro_torch.models import transformer as tfm

    work = WORK
    cfg = dr_bert_base.full_config()
    n_docs, chunk, steps = N_DOCS, 1024, (1000, 2000)
    t0 = time.perf_counter()
    for i, step in enumerate(steps):
        ckpt.save(os.path.join(work, "ckpts"), step,
                  {"params": tfm.init_numpy(cfg, i + 1)})
    emit({"phase": "main", "setup": "checkpoints", "steps": list(steps),
          "seconds": time.perf_counter() - t0})

    n_chunks = -(-n_docs // chunk)
    results, measured, windows = {}, {}, {}
    # the four runs at the default --scan_window (8: the torch route folds
    # the corpus's 8 chunks in one dispatch, the cuda route one chunk a
    # launch), then the torch route at windows 1 and 3 (3, 3, 1, 1)
    for impl, dt, window in (("cuda", "f32", None), ("cuda", "bf16", None),
                             ("cuda", "int8", None), ("torch", "f32", None),
                             ("torch", "f32", 1), ("torch", "f32", 3)):
        tag = f"{impl}_{dt}" + (f"_w{window}" if window else "")
        out = os.path.join(work, f"out_{tag}")
        reset_all_launches()
        t0 = time.perf_counter()
        with stage_dispatches() as dispatches:
            rc = cli.main([
                "--query_file", os.path.join(work, "q.jsonl"),
                "--candidate_dir", os.path.join(work, "corpus"),
                "--ckpts_dir", os.path.join(work, "ckpts"),
                "--qrel_file", os.path.join(work, "qrels.txt"),
                "--q_max_len", "32", "--p_max_len", "128",
                "--metrics", "MRR@10", "Recall@100", "--write_run",
                "--impl", impl, "--score_dtype", dt, "--chunk_size",
                str(chunk), "--batch_size", "256", "--output_dir", out]
                + (["--scan_window", str(window)] if window else []))
        seconds = time.perf_counter() - t0
        counts = all_launches()
        check(rc == 0, f"cli {tag} returned {rc} (validation errors)")
        with open(os.path.join(out, "asyncval_ledger.jsonl")) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        check([r["step"] for r in rows] == list(steps),
              f"{tag}: ledger steps {[r['step'] for r in rows]}")
        for r in rows:
            check(set(r) == LEDGER_KEYS, f"{tag}: ledger keys {sorted(r)}")
            check(r["score_dtype"] == dt and r["engine"] == "streaming",
                  f"{tag}: row {r['engine']}/{r['score_dtype']}")
            check(all(math.isfinite(v) for v in r["metrics"].values()),
                  f"{tag}: metrics {r['metrics']}")
        want = {key: 0 for key in counts}
        if impl == "cuda":
            want[f"topk_mips_{dt}"] = n_chunks * len(steps)
        check(counts == want, f"{tag}: kernel launches {counts}, "
              f"expected {want}")
        # the engine's dispatches: the cuda stage takes one chunk a step
        # (window 1), the torch stage the default window's schedule
        w = window or 8
        want_steps = {"step": n_chunks, "step_window": 0} if impl == "cuda" \
            else {"step": sum(n == 1 for _, n in
                              engine_lib.plan_schedule(n_chunks, w)),
                  "step_window": sum(n > 1 for _, n in
                                     engine_lib.plan_schedule(n_chunks, w))}
        want_steps = {key: v * len(steps) for key, v in want_steps.items()}
        check(dispatches == want_steps, f"{tag}: engine dispatches "
              f"{dispatches}, expected {want_steps}")
        row = {"phase": "main", "impl": impl, "score_dtype": dt,
               "launches": counts, "seconds": seconds,
               "metrics": {r["step"]: r["metrics"] for r in rows},
               "timings": {r["step"]: r["timings"] for r in rows}}
        if impl == "torch":
            windows[w] = {"window": w, "out": out, "rows": rows,
                          "dispatches": sum(dispatches.values()),
                          "by_kind": dict(dispatches), "seconds": seconds}
        if window:
            row["scan_window"] = window
            emit(row)
            continue
        results[(impl, dt)] = rows
        if impl == "cuda":
            measured[dt] = counts[f"topk_mips_{dt}"]
        emit(row)
    for a, b in zip(results[("cuda", "f32")], results[("torch", "f32")]):
        for name, v in a["metrics"].items():
            check(abs(v - b["metrics"][name]) <= 1e-6,
                  f"step {a['step']} {name}: cuda {v} vs torch "
                  f"{b['metrics'][name]}")
    main_window_part(windows, steps)
    return measured, results


@contextlib.contextmanager
def stage_dispatches():
    """Count the streaming engine's dispatches to the retrieval stages
    (``step`` and ``step_window`` calls from the engine, not the steps a
    window folds) while the block runs."""
    from repro_torch.core import engine
    counts = {"step": 0, "step_window": 0}
    real = {(cls, name): cls.__dict__[name]
            for cls in (engine.StreamTopKStage, engine.CudaStreamTopKStage)
            for name in counts if name in cls.__dict__}
    inside = threading.local()

    def counted(name, fn):
        def call(self, *args, **kwargs):
            depth = getattr(inside, "depth", 0)
            if not depth:
                counts[name] += 1
            inside.depth = depth + 1
            try:
                return fn(self, *args, **kwargs)
            finally:
                inside.depth = depth
        return call

    for (cls, name), fn in real.items():
        setattr(cls, name, counted(name, fn))
    try:
        yield counts
    finally:
        for (cls, name), fn in real.items():
            setattr(cls, name, fn)


def main_window_part(windows, steps):
    """``--scan_window``: the torch route's runs at windows 1, 3 and 8 give
    byte-identical TREC runs and equal ledger metrics; one line with each
    run's ``encode_corpus_s`` / ``total_s`` by step and its dispatches."""
    base = windows[8]
    for w, run in windows.items():
        for step in steps:
            name = f"asyncval_step{step}.trec"
            with open(os.path.join(run["out"], name), "rb") as f:
                got = f.read()
            with open(os.path.join(base["out"], name), "rb") as f:
                want = f.read()
            check(got == want, f"--scan_window {w}: {name} differs from "
                  "the window-8 run")
        for got, want in zip(run["rows"], base["rows"]):
            check(got["metrics"] == want["metrics"],
                  f"--scan_window {w} step {got['step']}: metrics "
                  f"{got['metrics']} vs {want['metrics']}")
    emit({"phase": "main", "part": "scan_window", "impl": "torch",
          "score_dtype": "f32", "runs_identical": True,
          "runs": [{"window": w, "dispatches": run["dispatches"],
                    "dispatches_by_kind": run["by_kind"],
                    "seconds": run["seconds"],
                    "encode_corpus_s": {r["step"]:
                                        r["timings"]["encode_corpus_s"]
                                        for r in run["rows"]},
                    "total_s": {r["step"]: r["timings"]["total_s"]
                                for r in run["rows"]}}
                   for w, run in sorted(windows.items())]})


# ---------------------------------------------------------------------------
# phase 5b: the paper's subset and rerank path on the main phase's data
# ---------------------------------------------------------------------------

# gates of the subset phase: materialized against streaming (and rerank
# across engines) on the card: at most this share of (step, query) top-k
# lists may differ, and no metric by more than this
LIST_SHARE, METRIC_TOL = 0.01, 1e-4
SUBSET_DEPTH = 100
FIDELITY_STEP = 3000


class CliRunner:
    """Runs ``repro_torch.core.cli.main`` over the main phase's files with
    ``--write_run``, launch counts set to 0 just before and read just after
    each run; returns its ledger rows and runs."""

    def __init__(self, work, steps):
        self.work = work
        self.steps = list(steps)

    def __call__(self, tag, extra, *, candidate_dir=None, ckpts=None,
                 steps=None):
        from repro_torch.core import cli
        from repro_torch.core.metrics import read_trec_run
        out = os.path.join(self.work, f"subset_{tag}")
        steps = self.steps if steps is None else steps
        reset_all_launches()
        t0 = time.perf_counter()
        rc = cli.main([
            "--query_file", os.path.join(self.work, "q.jsonl"),
            "--candidate_dir", candidate_dir
            or os.path.join(self.work, "corpus"),
            "--ckpts_dir", ckpts or os.path.join(self.work, "ckpts"),
            "--qrel_file", os.path.join(self.work, "qrels.txt"),
            "--q_max_len", "32", "--p_max_len", "128",
            "--metrics", "MRR@10", "Recall@100", "--write_run",
            "--output_dir", out] + extra)
        seconds = time.perf_counter() - t0
        counts = {k: n for k, n in all_launches().items() if n}
        check(rc == 0, f"{tag}: cli returned {rc} (validation errors)")
        with open(os.path.join(out, "asyncval_ledger.jsonl")) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        check([r["step"] for r in rows] == steps,
              f"{tag}: ledger steps {[r['step'] for r in rows]}")
        for r in rows:
            check(set(r) == LEDGER_KEYS, f"{tag}: ledger keys {sorted(r)}")
            check(all(math.isfinite(v) for v in r["metrics"].values()),
                  f"{tag}: metrics {r['metrics']}")
        runs = {step: read_trec_run(os.path.join(
            out, f"asyncval_step{step}.trec")) for step in steps}
        return {"tag": tag, "rows": rows, "runs": runs, "counts": counts,
                "seconds": seconds, "out": out}


def held(a, b, name):
    """Engine ``b`` against engine ``a`` on the card: the (step, query)
    top-k lists that differ and the largest metric difference, gated."""
    differ = total = 0
    for step, run in a["runs"].items():
        other = b["runs"][step]
        check(set(run) == set(other), f"{name}: query sets differ")
        for qid, ranked in run.items():
            total += 1
            differ += [d for d, _ in ranked] != [d for d, _ in other[qid]]
    diff = max((abs(v - rb["metrics"][m]) for ra, rb in zip(a["rows"],
                                                             b["rows"])
                for m, v in ra["metrics"].items()), default=0.0)
    check(differ <= LIST_SHARE * total, f"{name}: {differ} of {total} top-k "
          f"lists differ (at most {LIST_SHARE:.0%})")
    check(diff <= METRIC_TOL, f"{name}: metrics differ by {diff:.3g}")
    return {"lists_differ": differ, "lists": total, "max_metric_diff": diff}


def lexical_subset(ds):
    """Subset phase (a): the port's lexical baseline run (top 100, 30% of
    query tokens dropped) as a TREC run, and the splitter at depth 100;
    every gold passage must be kept.  Returns (run file, subset dir)."""
    from repro_torch.core import splitter
    from repro_torch.core.metrics import write_trec_run
    from repro_torch.data import corpus as corpus_lib
    t0 = time.perf_counter()
    base = corpus_lib.lexical_baseline_run(ds, k=SUBSET_DEPTH, drop_frac=0.3)
    run_path = os.path.join(WORK, "lexical.trec")
    write_trec_run(run_path, {q: [d for d, _ in v] for q, v in base.items()},
                   {q: [s for _, s in v] for q, v in base.items()},
                   tag="lexical")
    t_base = time.perf_counter() - t0
    sub_dir = os.path.join(WORK, "subset")
    t0 = time.perf_counter()
    check(splitter.main(["--candidate_dir", os.path.join(WORK, "corpus"),
                         "--run_file", run_path,
                         "--qrel_file", os.path.join(WORK, "qrels.txt"),
                         "--output_dir", sub_dir,
                         "--depth", str(SUBSET_DEPTH)]) == 0,
          "splitter failed")
    t_split = time.perf_counter() - t0
    kept = corpus_lib.read_jsonl(os.path.join(
        sub_dir, f"subset_top{SUBSET_DEPTH}.jsonl"))
    golds = {d for q in ds.qrels.values() for d in q}
    check(golds <= set(kept), f"the subset lost {len(golds - set(kept))} "
          "gold passages")
    emit({"phase": "subset", "part": "a", "passages": len(ds.corpus),
          "depth": SUBSET_DEPTH, "subset": len(kept), "golds": len(golds),
          "baseline_s": t_base, "splitter_s": t_split})
    return run_path, sub_dir


def subset_phase(device, ds, main_results):
    """(a) lexical baseline run + splitter at depth 100, (b) materialized vs
    streaming at f32 / bf16 / int8, (c) rerank on both engines and two
    ``--rerank_block`` values, (d) average_rank, (e) an mmap token store
    and its reuse, (f) fidelity of the subset ledger against the
    full-corpus ledger.  Returns the materialized runs' topk_mips launches
    per dtype."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import dr_bert_base
    from repro_torch.core import fidelity
    from repro_torch.kernels.topk_mips import ops
    from repro_torch.models import transformer as tfm
    work = WORK
    t_phase = time.perf_counter()
    steps = [r["step"] for r in main_results[("cuda", "f32")]]
    n_docs, chunk = len(ds.corpus), 1024
    n_chunks = -(-n_docs // chunk)
    run_cli = CliRunner(work, steps)

    # (a) the lexical baseline run and the splitter
    run_path, sub_dir = lexical_subset(ds)

    # (b) materialized against streaming, both encoding 1024 rows a batch
    lib = ops._lib(device)
    windows = len(ops._windows(n_docs, 100, 0, lib.cols, lib.max_cand))
    same = ["--impl", "cuda", "--batch_size", str(chunk), "--chunk_size",
            str(chunk)]
    mat_launches = {}
    for dt in ("f32", "bf16", "int8"):
        key = f"topk_mips_{dt}"
        st = run_cli(f"stream_{dt}", same + ["--score_dtype", dt])
        check(st["counts"] == {key: n_chunks * len(steps)},
              f"streaming {dt}: launches {st['counts']}")
        mat = run_cli(f"mat_{dt}", same + ["--score_dtype", dt,
                                           "--engine", "materialized"])
        check(mat["counts"] == {key: windows * len(steps)},
              f"materialized {dt}: launches {mat['counts']}, expected "
              f"{windows} window(s) x {len(steps)} checkpoints")
        check(all(r["engine"] == "materialized" for r in mat["rows"]),
              f"materialized {dt}: engine {mat['rows'][0]['engine']}")
        mat_launches[dt] = mat["counts"].get(key, 0)
        emit({"phase": "subset", "part": "b", "score_dtype": dt,
              **held(st, mat, f"materialized {dt}"),
              "launches": {"streaming": st["counts"],
                           "materialized": mat["counts"]},
              "windows_per_call": windows,
              "timings": {"streaming": {r["step"]: r["timings"]
                                        for r in st["rows"]},
                          "materialized": {r["step"]: r["timings"]
                                           for r in mat["rows"]}},
              "seconds": {"streaming": st["seconds"],
                          "materialized": mat["seconds"]}})

    # (c) rerank over the baseline's per-query top 100
    rerank = same + ["--mode", "rerank", "--sampler", "rerank_topk",
                     "--depth", str(SUBSET_DEPTH), "--run_file", run_path]
    st = run_cli("rerank_stream", rerank)
    blocks = {b: run_cli(f"rerank_mat_b{b}", rerank + [
        "--engine", "materialized", "--rerank_block", str(b)])
        for b in (16, 256)}
    for r in (st, *blocks.values()):
        check(not r["counts"], f"{r['tag']}: kernel launches {r['counts']}")
    check(blocks[16]["runs"] == blocks[256]["runs"],
          "rerank runs differ between --rerank_block 16 and 256")
    emit({"phase": "subset", "part": "c", "mode": "rerank",
          **held(st, blocks[16], "rerank streaming vs materialized"),
          "blocks_identical": True, "subset_size": st["rows"][0]
          ["subset_size"],
          "timings": {"streaming": {r["step"]: r["timings"]
                                    for r in st["rows"]},
                      **{f"materialized_b{b}": {r["step"]: r["timings"]
                                                for r in v["rows"]}
                         for b, v in blocks.items()}}})

    # (d) average rank over the DPR pool
    avg = run_cli("average_rank", same + [
        "--mode", "average_rank", "--sampler", "qrel_pool", "--depth", "30",
        "--run_file", run_path])
    for r in avg["rows"]:
        check(set(r["metrics"]) == {"MRR@10", "Recall@100", "AverageRank"},
              f"average_rank: metrics {sorted(r['metrics'])}")
    emit({"phase": "subset", "part": "d", "mode": "average_rank",
          "metrics": {r["step"]: r["metrics"] for r in avg["rows"]},
          "subset_size": avg["rows"][0]["subset_size"],
          "launches": avg["counts"]})

    # (e) an mmap token store, built once, then reused untouched
    mm = os.path.join(work, "token_cache")
    main_args = ["--impl", "cuda", "--score_dtype", "bf16", "--batch_size",
                 "256", "--chunk_size", str(chunk), "--token_backing",
                 "mmap", "--mmap_dir", mm]
    first = run_cli("mmap_1", main_args)
    cache = os.path.join(mm, "corpus_tokens")

    def stats():
        return {n: (os.stat(os.path.join(cache, n)).st_mtime_ns,
                    os.path.getsize(os.path.join(cache, n)))
                for n in sorted(os.listdir(cache))}

    before = stats()
    with open(os.path.join(cache, "store_meta.json"), "rb") as f:
        meta = f.read()
    second = run_cli("mmap_2", main_args)
    with open(os.path.join(cache, "store_meta.json"), "rb") as f:
        check(f.read() == meta, "mmap: store_meta.json changed")
    check(stats() == before, "mmap: the second run rewrote the cache")
    memory = main_results[("cuda", "bf16")]
    for r in (first, second):
        check(r["counts"] == {"topk_mips_bf16": n_chunks * len(steps)},
              f"{r['tag']}: launches {r['counts']}")
        check([x["metrics"] for x in r["rows"]]
              == [x["metrics"] for x in memory],
              f"{r['tag']}: metrics differ from the memory-backed run")
    emit({"phase": "subset", "part": "e", "backing": "mmap",
          "files": before, "metrics_equal_memory": True, "reused": True,
          "seconds": {"build_run": first["seconds"],
                      "reuse_run": second["seconds"]},
          "timings": {"build_run": {r["step"]: r["timings"]
                                    for r in first["rows"]},
                      "reuse_run": {r["step"]: r["timings"]
                                    for r in second["rows"]}}})

    # (f) fidelity: the splitter's subset against the full corpus, MRR@10
    # over the main phase's checkpoints and one more
    ckpts3 = os.path.join(work, "ckpts_fidelity")
    os.makedirs(ckpts3, exist_ok=True)
    for step in steps:
        name = os.path.basename(ckpt._step_dir(ckpts3, step))
        os.symlink(os.path.join(work, "ckpts", name),
                   os.path.join(ckpts3, name))
    ckpt.save(ckpts3, FIDELITY_STEP,
              {"params": tfm.init_numpy(dr_bert_base.full_config(),
                                        len(steps) + 1)})
    fsteps = steps + [FIDELITY_STEP]
    fid = ["--impl", "cuda", "--batch_size", "256", "--chunk_size",
           str(chunk)]
    full = run_cli("fidelity_full", fid, ckpts=ckpts3, steps=fsteps)
    sub = run_cli("fidelity_subset", fid, ckpts=ckpts3, steps=fsteps,
                  candidate_dir=sub_dir)
    ref = [r["metrics"]["MRR@10"] for r in full["rows"]]
    est = [r["metrics"]["MRR@10"] for r in sub["rows"]]
    report = fidelity.fidelity_report(ref, est)
    check(all(math.isfinite(v) for v in report.values()),
          f"fidelity: {report}")
    emit({"phase": "subset", "part": "f", "metric": "MRR@10",
          "steps": fsteps, "full": ref, "subset": est,
          "subset_size": sub["rows"][0]["subset_size"], "report": report})
    emit({"phase": "subset", "ok": True,
          "seconds": time.perf_counter() - t_phase})
    return mat_launches


# ---------------------------------------------------------------------------
# phase 5d: the retrieval serving tier on the main phase's checkpoints
# ---------------------------------------------------------------------------

# served results per query and the query micro-batch: the CLIs' defaults
SERVE_K, SERVE_BATCH = 10, 8
# the hot-swap part: client threads, and swaps between the two checkpoints
# after the first install
SERVE_CLIENTS, SERVE_SWAPS = 8, 3
# MS MARCO passage's corpus (the paper's own example), at dr-bert-base's
# width; timed micro-batches per dtype
MSMARCO_N, MSMARCO_BATCHES = 8_841_823, 50
SERVE_DTYPES = ("f32", "bf16", "int8")


def serve_spec():
    """The CLIs' ``--arch dr-bert-base`` encoder: full width, on the card."""
    from repro_torch.configs import dr_bert_base
    from repro_torch.models.biencoder import biencoder_spec
    return biencoder_spec(dr_bert_base.full_config(), q_max_len=32,
                          p_max_len=128, device="cuda")


def serve_config(dt, k):
    """The main phase's scoring and token-store geometry (chunks of 1024
    corpus rows, 256 queries a batch) at ``score_dtype`` ``dt``."""
    from repro_torch.serve import ServeConfig
    return ServeConfig(k=k, score_dtype=dt, impl="cuda", batch_size=256,
                       chunk_size=1024, max_batch=SERVE_BATCH)


def serve_windows(device, n, k):
    from repro_torch.kernels.topk_mips import ops
    lib = ops._lib(device)
    return len(ops._windows(n, k, 0, lib.cols, lib.max_cand))


def percentile(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))] \
        if xs else None


def serve_phase(device, ds, main_results):
    """(a) the entry points, (b) parity with the validator per dtype, (c)
    hot-swap under load, (d) micro-batches against an MS MARCO-sized index.
    Returns the `_serve` rows of the kernels line (part d)."""
    from repro_torch.ckpt import checkpoint as ckpt
    t_phase = time.perf_counter()
    steps = [r["step"] for r in main_results[("cuda", "f32")]]
    spec = serve_spec()
    params = {s: ckpt.restore(os.path.join(WORK, "ckpts"), s,
                              template={"params": spec.param_shapes}
                              )[0]["params"] for s in steps}
    serve_cli_part(device, steps)
    serve_parity_part(device, ds, spec, params, steps)
    serve_swap_part(device, ds, spec, params, steps)
    rows = msmarco_part(device, ds, spec, params[steps[0]], steps[0])
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve", "ok": True,
          "seconds": time.perf_counter() - t_phase})
    return rows


def serve_cli_part(device, steps):
    """(a) ``python -m repro_torch.launch.serve`` (one-shot, the latest
    checkpoint) and ``repro_torch.core.cli --serve --keep_top_k 1`` (on a
    copy of the checkpoints), both at ``--impl cuda`` f32: exit 0, one swap
    event, the CLI's served step the selector's last pick and still on
    disk after GC, and the topk_mips launches: a window per micro-batch
    plus the verify's canary (and the validation's chunks on the CLI)."""
    import contextlib
    import io

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.core import cli
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import replay_swaps
    windows = serve_windows(device, N_DOCS, SERVE_K)
    batches = -(-N_QUERIES // SERVE_BATCH)
    files = ["--query_file", os.path.join(WORK, "q.jsonl"),
             "--candidate_dir", os.path.join(WORK, "corpus")]
    events = os.path.join(WORK, "serve_launch.jsonl")
    out = io.StringIO()
    reset_all_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = launch_serve.main(files + [
            "--ckpts_dir", os.path.join(WORK, "ckpts"), "--impl", "cuda",
            "--score_dtype", "f32", "--k", str(SERVE_K), "--max_batch",
            str(SERVE_BATCH), "--batch_size", "256",
            "--serve_events", events])
    seconds = time.perf_counter() - t0
    counts = {k: n for k, n in all_launches().items() if n}
    check(rc == 0, f"launch.serve returned {rc}")
    swaps = replay_swaps(events)
    check(swaps == [{"seq": 0, "step": steps[-1], "prev_step": -1}],
          f"launch.serve swaps {swaps}")
    want = {"topk_mips_f32": batches * windows + windows}
    check(counts == want, f"launch.serve launches {counts}, expected {want}")
    emit({"phase": "serve", "part": "a", "entry": "repro_torch.launch.serve",
          "served_step": steps[-1], "launches": counts,
          "windows_per_call": windows, "micro_batches": batches,
          "stdout": out.getvalue().strip().splitlines()[-1],
          "seconds": seconds})

    ckdir = os.path.join(WORK, "ckpts_serve")
    shutil.copytree(os.path.join(WORK, "ckpts"), ckdir)
    outdir = os.path.join(WORK, "serve_cli")
    out = io.StringIO()
    reset_all_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(files + [
            "--ckpts_dir", ckdir,
            "--qrel_file", os.path.join(WORK, "qrels.txt"),
            "--q_max_len", "32", "--p_max_len", "128",
            "--metrics", "MRR@10", "Recall@100", "--impl", "cuda",
            "--score_dtype", "f32", "--chunk_size", "1024",
            "--batch_size", "256", "--output_dir", outdir,
            "--keep_top_k", "1", "--serve", "--serve_k", str(SERVE_K)])
    seconds = time.perf_counter() - t0
    counts = {k: n for k, n in all_launches().items() if n}
    check(rc == 0, f"cli --serve returned {rc}")
    swaps = replay_swaps(os.path.join(outdir, "asyncval_serve.jsonl"))
    check(len(swaps) == 1, f"cli --serve swaps {swaps}")
    served = swaps[0]["step"]
    with open(os.path.join(outdir, "asyncval_control.jsonl")) as f:
        selects = [json.loads(line) for line in f if line.strip()]
    best = [e for e in selects if e["kind"] == "select"][-1]["best_step"]
    check(served == best, f"served step {served}, the selector's {best}")
    on_disk = ckpt.list_steps(ckdir)
    check(on_disk == [served], f"after GC: {on_disk}, served {served}")
    n_chunks = -(-N_DOCS // 1024)
    want = {"topk_mips_f32": n_chunks * len(steps) + batches * windows
            + windows}
    check(counts == want, f"cli --serve launches {counts}, expected {want}")
    emit({"phase": "serve", "part": "a", "entry": "repro_torch.core.cli "
          "--serve", "served_step": served, "selector_best": best,
          "steps_on_disk": on_disk, "launches": counts,
          "stdout": [ln for ln in out.getvalue().splitlines()
                     if ln.startswith("[serve]")], "seconds": seconds})
    shutil.rmtree(ckdir, ignore_errors=True)


def serve_parity_part(device, ds, spec, params, steps):
    """(b) Per dtype at ``--impl cuda``: an index of the first checkpoint,
    all 256 queries through ``QueryService.answer`` (k=100, 32
    micro-batches of 8) against the main phase's ledger and TREC run of
    that checkpoint (at most 1% of lists and 1e-4 on metrics apart: the
    validator encodes the queries 256 at a time), and against
    ``retrieve_run(impl="cuda")`` over the index's embeddings and the same
    query embeddings (bit-equal: the same kernel on the same operands).
    At f32, one micro-batch of 8 (k=10) is traced: device time by kernel
    and the idle share of its wall."""
    from repro_torch.core.metrics import compute_metrics, read_trec_run
    from repro_torch.core.retrieval import retrieve_run
    from repro_torch.data.corpus import pad_batch
    from repro_torch.serve import IndexBuilder, QueryService
    step = steps[0]
    qids = sorted(ds.queries)
    items = [(q, ds.queries[q]) for q in qids]
    for dt in SERVE_DTYPES:
        t0 = time.perf_counter()
        index = IndexBuilder(spec, ds.corpus, serve_config(dt, 100)).build(
            params[step], step)
        svc = QueryService(spec, k=100, max_batch=SERVE_BATCH)
        svc.install(index)
        reset_all_launches()
        resp = svc.answer(items)
        counts = {k: n for k, n in all_launches().items() if n}
        served = {r.qid: r.doc_ids for r in resp}
        scores = {r.qid: r.scores for r in resp}
        out = os.path.join(WORK, f"out_cuda_{dt}")
        val = read_trec_run(os.path.join(out, f"asyncval_step{step}.trec"))
        with open(os.path.join(out, "asyncval_ledger.jsonl")) as f:
            row = next(r for r in map(json.loads, f) if r["step"] == step)
        differ = sum(served[q] != [d for d, _ in val[q]] for q in qids)
        metrics = compute_metrics(served, ds.qrels, ["MRR@10", "Recall@100"])
        diff = max(abs(v - row["metrics"][m]) for m, v in metrics.items())
        check(differ <= LIST_SHARE * len(qids), f"serve {dt}: {differ} of "
              f"{len(qids)} top-k lists differ from the validator's")
        check(diff <= METRIC_TOL, f"serve {dt}: metrics differ by {diff:.3g}")
        # the query embeddings the service scored, batch by batch
        with torch.inference_mode():
            q_emb = torch.cat([spec.encode_query(
                index.params, *(torch.from_numpy(a).to(device) for a in
                                pad_batch([t for _, t in items[i:i + 8]],
                                          spec.q_max_len)))
                for i in range(0, len(items), SERVE_BATCH)])
        rr_run, rr_scores = retrieve_run(qids, q_emb, index.doc_ids,
                                         index.emb, k=100, impl="cuda",
                                         score_dtype=dt)
        check(rr_run == served and rr_scores == scores,
              f"serve {dt}: answers differ from retrieve_run on the same "
              "operands")
        emit({"phase": "serve", "part": "b", "score_dtype": dt, "step": step,
              "lists_differ": differ, "lists": len(qids),
              "max_metric_diff": diff, "metrics": metrics,
              "validator_metrics": row["metrics"],
              "retrieve_run_equal": True, "launches": counts,
              "resident_dtype": str(index.emb.dtype).replace("torch.", ""),
              "build_s": index.build_s,
              "seconds": time.perf_counter() - t0})
        if dt == "f32":
            # where one served micro-batch's time goes (k = 10)
            one = QueryService(spec, k=SERVE_K, max_batch=SERVE_BATCH)
            one.install(index)
            one.answer(items[:SERVE_BATCH])
            emit(traced("serve_micro_batch",
                        lambda: one.answer(items[:SERVE_BATCH]),
                        TOPK_KERNELS))
            del one
        del index, svc


def serve_swap_part(device, ds, spec, params, steps):
    """(c) Hot-swap under load, under deterministic algorithms (set and
    undone here, as the train phase does): the expected answer of every
    (step, query) precomputed through ``answer`` at max_batch 8; then
    8 client threads submit the 256 queries in a loop to the started
    batcher (flush 4 ms, admission bound 256) while the promoter's
    background loop swaps between the two checkpoints 3 times (through
    ``target_fn``).  Gates: nothing dropped, rejected or timed out; every
    response bit-equal to the precomputed answer of the step it names;
    ``replay_swaps`` of the log equal to the promoter's swaps; the swap
    events' provenance."""
    from repro_torch.serve import (AdmissionController, IndexBuilder,
                                   Promoter, QueryService, replay_swaps)

    class TimedBuilder(IndexBuilder):
        def build(self, p, step):
            t0 = time.perf_counter()
            index = super().build(p, step)
            self.intervals.append((t0, time.perf_counter()))
            return index

    class TimedPromoter(Promoter):
        def poll_once(self):
            t0 = time.perf_counter()
            swapped = super().poll_once()
            if swapped:
                self.promote_s.append(time.perf_counter() - t0)
            return swapped

    saved_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    fill = torch.utils.deterministic.fill_uninitialized_memory
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    qids = sorted(ds.queries)
    items = [(q, ds.queries[q]) for q in qids]
    try:
        builder = TimedBuilder(spec, ds.corpus, serve_config("f32", SERVE_K))
        builder.intervals = []
        expected, first = {}, None
        for step in steps:
            index = builder.build(params[step], step)
            svc = QueryService(spec, k=SERVE_K, max_batch=SERVE_BATCH)
            svc.install(index)
            for r in svc.answer(items):
                expected[(step, r.qid)] = (r.doc_ids, r.scores)
            if first is None:
                first = index
        builder.intervals.clear()
        adm = AdmissionController(256)
        service = QueryService(spec, k=SERVE_K, max_batch=SERVE_BATCH,
                               flush_ms=4.0, admission=adm)
        service.install(first)
        del first, index, svc
        target = [steps[0]]
        log = os.path.join(WORK, "serve_swap_events.jsonl")
        if os.path.exists(log):
            os.remove(log)
        promoter = TimedPromoter(builder, service,
                                 os.path.join(WORK, "ckpts"),
                                 target_fn=lambda: target[0], log=log,
                                 poll_interval_s=0.05)
        promoter.promote_s = []
        stop = threading.Event()
        lock = threading.Lock()
        records, errors = [], []

        def client(i):
            j = 0
            while not stop.is_set():
                qid, toks = items[(i * 32 + j) % len(items)]
                j += 1
                t0 = time.perf_counter()
                try:
                    r = service.submit(qid, toks, timeout=60)
                except Exception as e:   # a dropped query is a blackout
                    with lock:
                        errors.append(repr(e))
                    return
                t1 = time.perf_counter()
                ok = (r.doc_ids, r.scores) == expected[(r.step, r.qid)]
                with lock:
                    records.append((t0, t1, r.step, ok))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_CLIENTS)]
        service.start()
        t_load = time.perf_counter()
        for t in threads:
            t.start()
        promoter.start()
        try:
            time.sleep(2.0)                       # load on an idle index
            for i in range(SERVE_SWAPS):
                target[0] = steps[(i + 1) % len(steps)]
                deadline = time.perf_counter() + 180
                while service.live_step() != target[0] \
                        and not promoter.failures \
                        and time.perf_counter() < deadline:
                    time.sleep(0.01)
                check(service.live_step() == target[0],
                      f"swap {i + 1} to {target[0]} did not land "
                      f"({promoter.failures})")
                time.sleep(1.0)                   # load on the new index
        finally:
            stop.set()
            for t in threads:
                t.join(120)
            promoter.stop()
            service.stop()
        wall = time.perf_counter() - t_load
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        if saved_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved_env
    check(not any(t.is_alive() for t in threads), "a client did not stop")
    check(not errors, f"{len(errors)} queries dropped: {errors[:3]}")
    check(adm.rejected == 0, f"{adm.rejected} queries rejected")
    wrong = sum(not ok for *_, ok in records)
    check(wrong == 0, f"{wrong} of {len(records)} responses differ from "
          "their step's precomputed answer")
    check(not promoter.failures, f"promotions failed: {promoter.failures}")
    check(len(promoter.swaps) == SERVE_SWAPS,
          f"{len(promoter.swaps)} swaps, expected {SERVE_SWAPS}")
    timeline = replay_swaps(log)
    check([(t["prev_step"], t["step"]) for t in timeline]
          == [(p, w) for p, w in promoter.swaps],
          f"replay {timeline} vs swaps {promoter.swaps}")
    swap_events = [e for e in promoter.log.events() if e.kind == "swap"]
    for e in swap_events:
        check(e.payload["score_dtype"] == "f32"
              and e.payload["impl"] == "cuda"
              and e.payload["n_docs"] == N_DOCS,
              f"swap event provenance {e.payload}")
    building = builder.intervals

    def during_build(t0, t1):
        return any(t0 < b1 and b0 < t1 for b0, b1 in building)

    lat = {"idle": [], "build": []}
    for t0, t1, *_ in records:
        lat["build" if during_build(t0, t1) else "idle"].append(
            (t1 - t0) * 1e3)
    emit({"phase": "serve", "part": "c", "clients": SERVE_CLIENTS,
          "deterministic_algorithms": True,
          "responses": len(records), "wrong": wrong, "dropped": len(errors),
          "rejected": adm.rejected, "swaps": promoter.swaps,
          "replay_equal": True,
          "steps_served": sorted({s for _, _, s, _ in records}),
          "latency_ms": {k: {"p50": percentile(v, 50),
                             "p99": percentile(v, 99), "n": len(v)}
                         for k, v in lat.items()},
          "qps": len(records) / wall, "wall_s": wall,
          "build_s": [e.payload["build_s"] for e in swap_events],
          "promote_s": promoter.promote_s,
          "batches": service.batches,
          "occupancy": service.served / max(1, service.batches
                                            * SERVE_BATCH),
          "admission_peak": adm.peak})


class _RowIds:
    """Doc ids ``p0 .. p{n-1}`` of a synthetic index, made on lookup."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, j):
        return f"p{j}"


def msmarco_part(device, ds, spec, params, step):
    """(d) A ``ServingIndex`` of N = 8,841,823 seeded unit rows (D = 768,
    drawn on the card: MS MARCO passage's corpus size, in place of an
    hours-long corpus encode), queries encoded by the full-width model of
    the first checkpoint, at f32 (27.2 GB resident), int8 over the same
    f32 matrix, then bf16 (13.6 GB; the f32 matrix freed).  Per dtype: one
    micro-batch of 8 held against ``topk_exact`` on the card (the same ids,
    scores within 1e-5); 50 micro-batches through ``answer`` (CUDA events
    around ``ServingIndex.topk``, wall per batch), launches per batch; the
    kernels alone on prepared inputs (``ms``, profiler ``device_ms`` by
    kernel, the host time of the window loop), the wrapper as serving
    calls it (int8: with the corpus quantization, also timed alone), the
    bytes bound and ``torch.topk(q @ c.T, 10)``."""
    from repro_torch.core.retrieval import topk_exact
    from repro_torch.data.corpus import pad_batch
    from repro_torch.kernels.topk_mips import ops
    from repro_torch.models.nn import to_torch_tree
    from repro_torch.serve import QueryService, ServingIndex

    class TimedIndex(ServingIndex):
        def topk(self, q_emb, *, k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = super().topk(q_emb, k=k)
            end.record()
            end.synchronize()
            self.times.append(start.elapsed_time(end))
            return out

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    N, D, Q, k = MSMARCO_N, spec.dim, SERVE_BATCH, SERVE_K
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    gen = torch.Generator(device=device).manual_seed(0)
    emb = torch.randn((N, D), generator=gen, device=device)
    emb.div_(emb.norm(dim=1, keepdim=True))
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    dev_params = to_torch_tree(params, device)
    items = [(q, ds.queries[q]) for q in sorted(ds.queries)[:Q]]
    service = QueryService(spec, k=k, max_batch=Q)
    windows = serve_windows(device, N, k)
    with torch.inference_mode():
        q = spec.encode_query(dev_params, *(
            torch.from_numpy(a).to(device)
            for a in pad_batch([t for _, t in items], spec.q_max_len)))
    emit({"phase": "serve", "part": "d", "setup": "index", "N": N, "D": D,
          "free_gb_before": free_gb, "generate_s": t_gen,
          "windows_per_call": windows})
    rows = {}
    for dt in ("f32", "int8", "bf16"):
        if dt == "bf16":
            emb = emb.to(torch.bfloat16)          # the f32 matrix is freed
            gc.collect()
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        index = TimedIndex(step=step, params=dev_params, doc_ids=_RowIds(N),
                           emb=emb, n_docs=N, score_dtype=dt, impl="cuda",
                           block=65536, build_s=t_gen)
        index.times = []
        service.install(index)
        # one micro-batch against the plain version on the card
        gs, gi = index.topk(q, k=k)
        resp = service.answer(items)
        check([r.doc_ids for r in resp] == [[f"p{j}" for j in row]
                                            for row in gi],
              f"msmarco {dt}: answer differs from the index's top-k")
        ws, wi = topk_exact(q, emb, k=k, block=65536, score_dtype=dt)
        ws, wi = ws.cpu().numpy(), wi.cpu().numpy()
        err = float(np.abs(gs - ws).max())
        check(np.array_equal(gi, wi), f"msmarco {dt}: ids differ from "
              "topk_exact")
        check(err <= TOL, f"msmarco {dt}: scores differ by {err:.3g}")
        plain_ms = cuda_time_ms(lambda: topk_exact(
            q, emb, k=k, block=65536, score_dtype=dt), iters=2)
        # the timed micro-batches
        index.times.clear()
        reset_all_launches()
        walls = []
        for _ in range(MSMARCO_BATCHES):
            t1 = time.perf_counter()
            service.answer(items)
            walls.append((time.perf_counter() - t1) * 1e3)
        counts = {key: n for key, n in all_launches().items() if n}
        check(counts == {f"topk_mips_{dt}": MSMARCO_BATCHES * windows},
              f"msmarco {dt}: launches {counts}, expected "
              f"{MSMARCO_BATCHES} x {windows}")
        batch_ms = list(index.times)
        # the pieces of one call
        qk, ck, qs, cs = ops._kernel_inputs(q, emb, dt)

        def kernel():
            return ops._topk_cuda(dt, qk, ck, qs, cs, k_target=k,
                                  n_valid=N)

        compare(dt, kernel(), (torch.from_numpy(gs).to(device),
                               torch.from_numpy(gi).to(device)),
                exact_ties=True)
        ms = cuda_time_ms(kernel, iters=5)
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            kernel()
            host.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        per_call = {"score_f32" if dt == "f32" else "score_tc": windows,
                    "select_topk": windows}
        dev_ms, by_kernel, records = device_ms_many(f"topk_serve_{dt}",
                                                    kernel, per_call)
        wrapper_ms = cuda_time_ms(
            lambda: ops.topk_mips(q, emb, k=k, score_dtype=dt), iters=5)
        quant_ms = cuda_time_ms(lambda: ops._kernel_inputs(q, emb, dt),
                                iters=3) if dt == "int8" else None
        library_ms = cuda_time_ms(serve_library(dt, q, emb, qk, ck, qs, cs,
                                                k), iters=5)
        nbytes = (Q + N) * D * ELEM_BYTES[dt] + 2 * Q * k * 4
        if dt == "int8":
            nbytes += (Q + N) * 4
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = 2 * Q * N * D / PEAK_OPS_S[dt] * 1e3
        batch_med = statistics.median(batch_ms)
        row = {"phase": "serve", "part": "d", "shape": "serve",
               "variant": dt, "Q": Q, "N": N, "D": D, "k": k,
               "resident_dtype": str(emb.dtype).replace("torch.", ""),
               "windows": windows,
               "launches_per_batch": counts[f"topk_mips_{dt}"]
               // MSMARCO_BATCHES,
               "max_abs_err": err, "batch_topk_ms": {
                   "median": batch_med, "min": min(batch_ms),
                   "max": max(batch_ms)},
               "batch_wall_ms": {"median": statistics.median(walls),
                                 "min": min(walls), "max": max(walls)},
               "ms": ms, "host_issue_ms": statistics.median(host),
               "device_ms": dev_ms, "device_ms_by_kernel": by_kernel,
               "profiler_records": records,
               "wrapper_ms": wrapper_ms, "quantize_ms": quant_ms,
               "host_share_of_batch": statistics.median(host) / batch_med,
               "quantize_share_of_batch": None if quant_ms is None
               else quant_ms / batch_med,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        emit(row)
        rows[dt] = dict(row, launches=counts[f"topk_mips_{dt}"])
        del qk, ck, qs, cs, index
    del emb, service
    return rows


def serve_library(dt, q, emb, qk, ck, qs, cs, k):
    """``torch.topk(q @ c.T, k)`` at the serving shape, as a function to
    time — the yardstick only.  int8 on the quantized operands:
    ``torch._int_mm`` takes more than 16 rows and a multiple of 8 columns,
    so q is zero-padded to 32 rows and c by zero rows, here, outside the
    timed call, and the pads' scores are sliced off."""
    if dt == "int8":
        qp = torch.cat([qk, qk.new_zeros((32 - qk.shape[0], qk.shape[1]))])
        pad = (-ck.shape[0]) % 8
        cp = torch.cat([ck, ck.new_zeros((pad, ck.shape[1]))]) if pad else ck
        n = ck.shape[0]
        return lambda: torch.topk(
            torch._int_mm(qp, cp.t())[:q.shape[0], :n].float()
            * qs[:, None] * cs[None, :], k)
    if dt == "bf16":
        qb = q.to(torch.bfloat16)
        return lambda: torch.topk((qb @ emb.T).float(), k)
    return lambda: torch.topk(q @ emb.T, k)


# ---------------------------------------------------------------------------
# phase 5e: the validator fleet and the sharded paths on the main phase's data
# ---------------------------------------------------------------------------

# (a) the in-process fleet's two tasks (both impl="cuda"): 2 checkpoints x 2
# tasks = 4 units, 8 topk_mips launches a unit (8 chunks of 1024)
FLEET_DTYPES = ("f32", "int8")
# (b) the SIGKILL run's lease, in ledger records
FLEET_KILL_TTL = 4
# (c), (d): four shards of one card, two mesh axes
FLEET_MESH = ((2, 2), ("data", "model"))
# (d) micro-batches of SERVE_BATCH queries at SERVE_K against the sharded
# MS MARCO-sized index
FLEET_SERVE_BATCHES = 10


def fleet_vcfg(dt, impl, mesh=None, **kw):
    """The main phase's CLI settings as a ValidationConfig."""
    from repro_torch.core.suite import ValidationConfig
    return ValidationConfig(metrics=("MRR@10", "Recall@100"), k=100,
                            batch_size=256, chunk_size=1024, impl=impl,
                            score_dtype=dt, mesh=mesh, **kw)


def fleet_phase(device, ds, main_results):
    """(a) two ``ValidatorWorker`` threads drain one ``WorkQueue``, (b)
    ``python -m repro_torch.launch.fleet`` and a SIGKILLed CLI worker,
    (c) sharded validation on a mesh of four shards of the card, (d)
    sharded serving at MS MARCO's size.  Returns the topk_mips launches
    of (a) by dtype."""
    t_phase = time.perf_counter()
    gc.collect()
    # the caching allocator may hold tens of GB after the serve phase; the
    # CLI workers of (b) are processes of their own and need that memory
    torch.cuda.empty_cache()
    steps = [r["step"] for r in main_results[("cuda", "f32")]]
    spec = serve_spec()
    launches = fleet_inproc_part(ds, main_results, spec, steps)
    gc.collect()
    torch.cuda.empty_cache()
    fleet_cli_part(main_results, steps)
    fleet_sharded_part(device, ds, main_results, spec, steps)
    gc.collect()
    torch.cuda.empty_cache()
    fleet_serve_part(device, ds, spec, steps[0])
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "fleet", "ok": True,
          "seconds": time.perf_counter() - t_phase})
    return launches


def fleet_rows_match(rows, main_results, impl, name):
    """Every ledger row's metrics within 1e-6 of the main phase's row of
    its step at its dtype; returns the largest difference."""
    worst = 0.0
    for r in rows:
        want = {m["step"]: m for m in main_results[(impl, r["score_dtype"])]}
        for metric, v in want[r["step"]]["metrics"].items():
            diff = abs(r["metrics"][metric] - v)
            worst = max(worst, diff)
            check(diff <= 1e-6, f"{name}: step {r['step']} "
                  f"{r['score_dtype']} {metric} {r['metrics'][metric]} vs "
                  f"the main phase's {v}")
    return worst


def fleet_fold_view(state):
    return {key: (st.status, st.holder, st.completed_by, st.abandons)
            for key, st in state.units.items()}


def fleet_inproc_part(ds, main_results, spec, steps):
    """(a) Two ``ValidatorWorker``\\ s on two threads, each on its own CUDA
    stream, drain one ``WorkQueue`` over a copy of the two checkpoints with
    a two-task suite (``f32`` and ``int8``, both ``impl="cuda"``): every
    unit completed once, claims split between the workers, exactly 8
    topk_mips launches per unit (read from the counters), metrics within
    1e-6 of the main phase's ``--impl cuda`` rows, and ``replay`` of the
    ledger equal to both workers' online fold."""
    from repro_torch.core.suite import ValidationSuite, ValidationTask
    from repro_torch.core.validator import ValidationLedger, ValidatorWorker
    from repro_torch.core.workqueue import WorkQueue, replay
    ckdir = os.path.join(WORK, "fleet_a_ckpts")
    shutil.rmtree(ckdir, ignore_errors=True)
    shutil.copytree(os.path.join(WORK, "ckpts"), ckdir)
    ledger = os.path.join(WORK, "fleet_a_ledger.jsonl")
    if os.path.exists(ledger):
        os.remove(ledger)

    def suite():
        # one engine per dtype, injected per task: a suite's tasks share
        # one config, and the two tasks score at two dtypes
        engines = {dt: ValidationSuite(spec, [ValidationTask(
            "default", ds.corpus, ds.queries, ds.qrels)],
            fleet_vcfg(dt, "cuda")).engine("default") for dt in FLEET_DTYPES}
        return ValidationSuite(spec, [
            ValidationTask(dt, ds.corpus, ds.queries, ds.qrels)
            for dt in FLEET_DTYPES], fleet_vcfg("f32", "cuda"),
            engines=engines)

    workers = []
    for wid in ("w0", "w1"):
        s = suite()
        workers.append(ValidatorWorker(
            ckdir, s, ledger=ValidationLedger(ledger,
                                              expected_tasks=s.task_names),
            queue=WorkQueue(ledger, wid, capabilities={"mesh_size": 1}),
            worker_id=wid))
    units = [u for step in steps
             for u in workers[0].pipeline.plan_units(step)]
    check(len(workers[0].queue.publish(units)) == len(units),
          "fleet (a): publication")
    stop = threading.Event()

    def drained():
        return len(replay(ledger).completed_units()) == len(units)

    threads = [threading.Thread(target=w.run_forever, args=(stop,),
                                kwargs={"idle_wait_s": 0.02,
                                        "drained": drained})
               for w in workers]
    reset_all_launches()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    stop.set()
    counts = all_launches()
    check(not any(t.is_alive() for t in threads),
          "fleet (a): a worker thread still runs")
    for w in workers:
        check(not w.errors, f"fleet (a) {w.worker_id}: {list(w.errors)}")
    n_chunks = -(-N_DOCS // 1024)
    want = {key: 0 for key in counts}
    for dt in FLEET_DTYPES:
        want[f"topk_mips_{dt}"] = n_chunks * len(steps)
    check(counts == want, f"fleet (a): launches {counts}, expected {want}")
    with open(ledger) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    rows = [r for r in recs if "kind" not in r]
    check(sorted((r["step"], r["task"]) for r in rows)
          == sorted(u.key for u in units),
          f"fleet (a): rows {[(r['step'], r['task']) for r in rows]}")
    check(all(r["task"] == r["score_dtype"] for r in rows),
          "fleet (a): a task scored at another dtype")
    by_worker = {w.worker_id: [list(u.key) for u in w.completed]
                 for w in workers}
    check(all(by_worker.values()), f"fleet (a): claims {by_worker}")
    check(sorted(r["worker_id"] for r in rows)
          == sorted(w for w, us in by_worker.items() for _ in us),
          "fleet (a): rows' worker ids differ from the completions")
    worst = fleet_rows_match(rows, main_results, "cuda", "fleet (a)")
    offline = replay(ledger)
    for w in workers:
        online = w.queue.refresh()
        check(online.events == offline.events
              and fleet_fold_view(online) == fleet_fold_view(offline),
              f"fleet (a): replay differs from {w.worker_id}'s fold")
    emit({"phase": "fleet", "part": "a", "units": len(units),
          "by_worker": by_worker, "launches": {k: n for k, n in
                                               counts.items() if n},
          "records": len(recs), "renews": sum(r.get("kind") == "renew"
                                              for r in recs),
          "metrics_max_diff": worst, "wall_s": wall,
          "unit_total_s": {f"{r['step']}/{r['task']}": r["timings"]
                           ["total_s"] for r in rows}})
    del workers, threads
    shutil.rmtree(ckdir, ignore_errors=True)
    return {dt: counts[f"topk_mips_{dt}"] for dt in FLEET_DTYPES}


def fleet_worker_argv(ckdir, outdir, extra=()):
    """``python -m repro_torch.core.cli --worker`` with the main phase's
    settings at ``--impl cuda`` f32."""
    return [sys.executable, "-m", "repro_torch.core.cli",
            "--query_file", os.path.join(WORK, "q.jsonl"),
            "--candidate_dir", os.path.join(WORK, "corpus"),
            "--ckpts_dir", ckdir,
            "--qrel_file", os.path.join(WORK, "qrels.txt"),
            "--q_max_len", "32", "--p_max_len", "128",
            "--metrics", "MRR@10", "Recall@100", "--impl", "cuda",
            "--score_dtype", "f32", "--chunk_size", "1024",
            "--batch_size", "256", "--output_dir", outdir, "--worker",
            *extra]


def fleet_copy(tag):
    """A fresh copy of the main phase's checkpoints with their COMMIT
    markers stamped now (the fleet's backlog lands at this moment), and an
    empty output directory."""
    from repro_torch.ckpt import checkpoint as ckpt
    ckdir = os.path.join(WORK, f"fleet_{tag}_ckpts")
    outdir = os.path.join(WORK, f"fleet_{tag}_out")
    for d in (ckdir, outdir):
        shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(WORK, "ckpts"), ckdir)
    for step in ckpt.list_steps(ckdir):
        os.utime(os.path.join(ckpt._step_dir(ckdir, step),
                              ckpt.COMMIT_MARKER))
    return ckdir, outdir


def fleet_watch(procs, ledger, t0, *, timeout=900):
    """Poll the ledger until every process in ``procs`` has exited: the
    seconds from ``t0`` at which each result row first appeared
    (checkpoint-to-verdict: the COMMIT markers were stamped at ``t0``)."""
    from repro_torch.core.workqueue import WorkQueue
    observer = WorkQueue(ledger, "observer")      # reads, never appends
    seen, deadline = {}, time.monotonic() + timeout
    while True:
        done = all(p.poll() is not None for p in procs)
        if os.path.exists(ledger):
            for r in observer.refresh().result_rows:
                seen.setdefault((r["step"], r["task"]),
                                time.perf_counter() - t0)
        if done:
            return seen
        if time.monotonic() > deadline:
            for p in procs:
                p.kill()
            raise RuntimeError(f"fleet: workers still running after "
                               f"{timeout} s")
        time.sleep(0.05)


def fleet_first_claim(proc, ledger, worker_id, *, timeout=600):
    """Wait until the ledger's fold shows ``worker_id`` holding a lease;
    returns that unit's key."""
    from repro_torch.core.workqueue import CLAIMED, WorkQueue
    observer = WorkQueue(ledger, "observer")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        check(proc.poll() is None, f"fleet kill: {worker_id} exited "
              f"({proc.returncode}) before it held a claim")
        if os.path.exists(ledger):
            held = [key for key, st in observer.refresh().units.items()
                    if st.status == CLAIMED and st.holder == worker_id]
            if held:
                return held[0]
        time.sleep(0.02)
    proc.kill()
    raise RuntimeError(f"fleet kill: {worker_id} held no claim in "
                       f"{timeout} s")


def fleet_cli_part(main_results, steps):
    """(b) ``python -m repro_torch.launch.fleet --workers 2 -- python -m
    repro_torch.core.cli --worker --impl cuda --score_dtype f32 ...`` on a
    fresh copy: exit 0, every step ledgered once, by the two workers, with
    the main phase's f32 metrics.  Then a second copy with ``--lease_ttl
    4``: a victim worker is SIGKILLed as soon as the ledger's fold shows
    it holding a lease, and a survivor started then must tick the dead
    lease out, reclaim the unit and complete it; every unit completed
    once, and ``replay`` attributes to the survivor exactly the units it
    reported completing online.  Walls and checkpoint-to-verdict (from the
    stamped COMMIT markers to each row's appearance in the ledger)."""
    from repro_torch.core.workqueue import replay
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])

    ckdir, outdir = fleet_copy("b")
    ledger = os.path.join(outdir, "asyncval_ledger.jsonl")
    log_path = os.path.join(WORK, "fleet_launcher.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        launcher = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.fleet", "--workers",
             "2", "--poll_interval", "0.2", "--"]
            + fleet_worker_argv(ckdir, outdir),
            env=env, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
    verdicts = fleet_watch([launcher], ledger, t0)
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        log = f.read()
    check(launcher.returncode == 0,
          f"launch.fleet returned {launcher.returncode}:\n{log[-4000:]}")
    state = replay(ledger)
    rows = state.result_rows
    check(sorted(r["step"] for r in rows) == steps,
          f"launch.fleet: ledgered steps {[r['step'] for r in rows]}")
    check(sorted(state.completed_units()) == [(s, "default") for s in steps]
          and len(state.units) == len(steps),
          f"launch.fleet: units {sorted(state.units)}")
    wids = sorted(r["worker_id"] for r in rows)
    check(set(wids) <= {"worker-0", "worker-1"},
          f"launch.fleet: worker ids {wids}")
    worst = fleet_rows_match(rows, main_results, "cuda", "launch.fleet")
    emit({"phase": "fleet", "part": "b", "run": "launch.fleet",
          "workers": 2, "worker_ids": wids, "wall_s": wall,
          "ckpt_to_verdict_s": {str(s): verdicts[(s, "default")]
                                for s in steps},
          "unit_total_s": {str(r["step"]): r["timings"]["total_s"]
                           for r in rows},
          "metrics_max_diff": worst})
    shutil.rmtree(ckdir, ignore_errors=True)

    ckdir, outdir = fleet_copy("kill")
    ledger = os.path.join(outdir, "asyncval_ledger.jsonl")
    extra = ["--lease_ttl", str(FLEET_KILL_TTL)]
    logs = {w: os.path.join(WORK, f"fleet_{w}.log")
            for w in ("victim", "survivor")}

    def start(worker_id):
        with open(logs[worker_id], "w") as f:
            return subprocess.Popen(
                fleet_worker_argv(ckdir, outdir,
                                  extra + ["--worker_id", worker_id]),
                env=env, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)

    # the victim dies holding its first lease, mid-unit; the survivor
    # starts then, so it always meets the dead lease
    t0 = time.perf_counter()
    victim = start("victim")
    killed = fleet_first_claim(victim, ledger, "victim")
    victim.send_signal(signal.SIGKILL)
    victim.wait(timeout=60)
    t_kill = time.perf_counter() - t0
    survivor = start("survivor")
    verdicts = fleet_watch([survivor], ledger, t0)
    wall = time.perf_counter() - t0
    with open(logs["survivor"]) as f:
        survivor_log = f.read()
    check(victim.returncode == -signal.SIGKILL,
          f"fleet kill: victim rc {victim.returncode}")
    check(survivor.returncode == 0,
          f"fleet kill: survivor returned {survivor.returncode}:"
          f"\n{survivor_log[-4000:]}")
    state = replay(ledger, lease_ttl=FLEET_KILL_TTL)
    rows = state.result_rows
    check(sorted((r["step"], r["task"]) for r in rows)
          == sorted(state.completed_units())
          == [(s, "default") for s in steps],
          f"fleet kill: rows {[(r['step'], r['task']) for r in rows]}")
    check(not [k for k, st in state.units.items() if st.status == "failed"],
          "fleet kill: a unit failed")
    reclaims = [e for e in state.events if e["event"] == "reclaim"]
    check(any((e["step"], e["task"]) == killed and e["from"] == "victim"
              and e["worker"] == "survivor" for e in reclaims),
          f"fleet kill: no reclaim of {killed} by the survivor: {reclaims}")
    online = sorted(
        (int(ln.split()[4]), ln.split()[6])
        for ln in survivor_log.splitlines()
        if ln.startswith("[asyncval] survivor completed step"))
    offline = sorted(k for k, st in state.units.items()
                     if st.completed_by == "survivor")
    check(online == offline == [(s, "default") for s in steps],
          f"fleet kill: the survivor completed {online} online, replay "
          f"attributes {offline}")
    worst = fleet_rows_match(rows, main_results, "cuda", "fleet kill")
    emit({"phase": "fleet", "part": "b", "run": "sigkill",
          "lease_ttl": FLEET_KILL_TTL, "killed_unit": list(killed),
          "killed_at_s": t_kill, "reclaims": reclaims, "wall_s": wall,
          "ckpt_to_verdict_s": {f"{s}/{t}": v
                                for (s, t), v in sorted(verdicts.items())},
          "metrics_max_diff": worst})
    shutil.rmtree(ckdir, ignore_errors=True)


def fleet_runs(eng, params, steps, qrels, metrics):
    """``eng.run`` per checkpoint -> the ``held`` record: TREC-shaped runs
    and rows of metrics, in step order."""
    from repro_torch.core.metrics import compute_metrics
    runs, rows, seconds = {}, [], {}
    for step in steps:
        run, scores, timings = eng.run(params[step])
        runs[step] = {q: list(zip(run[q], scores[q])) for q in run}
        rows.append({"step": step, "metrics": compute_metrics(
            run, qrels, list(metrics))})
        seconds[str(step)] = timings["total_s"]
    return {"runs": runs, "rows": rows, "total_s": seconds}


def fleet_sharded_part(device, ds, main_results, spec, steps):
    """(c) Validation on ``make_mesh((2, 2), ("data", "model"),
    devices=[cuda:0] * 4)`` at full width: ``impl="torch"`` f32 retrieval
    (``topk_sharded``) against the main phase's unsharded ``--impl torch``
    rows and runs, and rerank over the baseline's top 100
    (``rerank_sharded``) against the unsharded rerank stage; no topk_mips
    launch in these runs (the reference's XLA route); at most 1% of
    (step, query) top-k lists and no metric by more than 1e-4 apart.  The
    four shards share the card, so the card encodes and scores their rows
    in one call each (``engine.device_batches``) and the merges run per
    shard.  ``impl="cuda"`` with the mesh: the route ignores it, 8
    launches per checkpoint."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.core.metrics import read_trec_run
    from repro_torch.core.registry import SAMPLERS
    from repro_torch.core.suite import ValidationSuite, ValidationTask
    from repro_torch.distributed import compat
    shape, axes = FLEET_MESH
    mesh = compat.make_mesh(shape, axes, [device] * math.prod(shape))
    params = {s: ckpt.restore(os.path.join(WORK, "ckpts"), s,
                              template={"params": spec.param_shapes}
                              )[0]["params"] for s in steps}
    names = ("MRR@10", "Recall@100")

    def engine(vcfg, **task_kw):
        return ValidationSuite(spec, [ValidationTask(
            "default", ds.corpus, ds.queries, ds.qrels, **task_kw)],
            vcfg).engine("default")

    # retrieval: sharded against the main phase's unsharded torch run
    eng = engine(fleet_vcfg("f32", "torch", mesh))
    check(eng.stage.name == "topk_sharded" and eng.query_mesh is mesh,
          f"fleet (c): stage {eng.stage.name}")
    reset_all_launches()
    t0 = time.perf_counter()
    sharded = fleet_runs(eng, params, steps, ds.qrels, names)
    seconds = time.perf_counter() - t0
    counts = {k: n for k, n in all_launches().items() if n}
    check(not counts, f"fleet (c) retrieval: kernel launches {counts}")
    main = {"runs": {s: read_trec_run(os.path.join(
        WORK, "out_torch_f32", f"asyncval_step{s}.trec")) for s in steps},
        "rows": main_results[("torch", "f32")]}
    emit({"phase": "fleet", "part": "c", "mode": "retrieval",
          "impl": "torch", "mesh": dict(mesh.shape), "stage": eng.stage.name,
          **held(main, sharded, "sharded retrieval"), "launches": counts,
          "total_s": sharded["total_s"],
          "main_total_s": {str(r["step"]): r["timings"]["total_s"]
                           for r in main_results[("torch", "f32")]},
          "seconds": seconds})
    del eng

    fleet_rounding_part(device, ds, spec, params[steps[0]])

    # rerank over the baseline's top 100: sharded against unsharded
    run_path = os.path.join(WORK, "lexical.trec")
    if not os.path.exists(run_path):
        lexical_subset(ds)
    baseline = read_trec_run(run_path)
    out = {}
    for tag, m in (("unsharded", None), ("sharded", mesh)):
        eng = engine(fleet_vcfg("f32", "torch", m, mode="rerank"),
                     sampler=SAMPLERS.get("rerank_topk")(depth=SUBSET_DEPTH),
                     baseline_run=baseline)
        check(eng.stage.name == ("rerank_sharded" if m else "rerank"),
              f"fleet (c) rerank: stage {eng.stage.name}")
        reset_all_launches()
        t0 = time.perf_counter()
        out[tag] = fleet_runs(eng, params, steps, ds.qrels, names)
        out[tag]["seconds"] = time.perf_counter() - t0
        counts = {k: n for k, n in all_launches().items() if n}
        check(not counts, f"fleet (c) rerank {tag}: launches {counts}")
        del eng
    emit({"phase": "fleet", "part": "c", "mode": "rerank", "impl": "torch",
          "mesh": dict(mesh.shape),
          **held(out["unsharded"], out["sharded"], "sharded rerank"),
          "total_s": {tag: r["total_s"] for tag, r in out.items()},
          "seconds": {tag: r["seconds"] for tag, r in out.items()}})

    # impl="cuda" with the mesh: the single-device kernel, 8 launches
    eng = engine(fleet_vcfg("f32", "cuda", mesh))
    check(eng.stage.name == "topk_cuda" and eng.query_mesh is mesh,
          f"fleet (c) cuda: stage {eng.stage.name}")
    reset_all_launches()
    got = fleet_runs(eng, params, steps[:1], ds.qrels, names)
    counts = {k: n for k, n in all_launches().items() if n}
    n_chunks = -(-N_DOCS // 1024)
    check(counts == {"topk_mips_f32": n_chunks},
          f"fleet (c) cuda: launches {counts}, expected {n_chunks}")
    main = {"runs": {steps[0]: read_trec_run(os.path.join(
        WORK, "out_cuda_f32", f"asyncval_step{steps[0]}.trec"))},
        "rows": main_results[("cuda", "f32")][:1]}
    emit({"phase": "fleet", "part": "c", "mode": "retrieval", "impl": "cuda",
          "mesh": dict(mesh.shape), "stage": eng.stage.name,
          **held(main, got, "cuda with a mesh"), "launches": counts,
          "total_s": got["total_s"]})
    del eng, params


def fleet_rounding_part(device, ds, spec, params):
    """(c) Why a device scores all its shards' rows in one product, on
    the first checkpoint at f32 (informational, no gate): the corpus
    encoded 1024 and 256 rows a call and the queries 256 and 64 (the
    rows that differ), and each chunk's scores as one 1024-column product
    against four 256-column ones (the share of scores that differ, the
    largest difference, the top-100 lists that move, and the median gap
    between neighbouring top-100 scores)."""
    from repro_torch.data.corpus import pad_batch
    from repro_torch.kernels.topk_mips.ref import scores_ref, select_topk
    from repro_torch.models.nn import to_torch_tree
    p = to_torch_tree(params, device)
    shards = math.prod(FLEET_MESH[0])

    def encode(texts, max_len, rows):
        out = []
        for i in range(0, len(texts), rows):
            t, m = pad_batch(texts[i:i + rows], max_len)
            out.append(spec.encode_passage(p, torch.from_numpy(t).to(device),
                                           torch.from_numpy(m).to(device)))
        return torch.cat(out)

    def scores(q, e, cols):
        return torch.cat([scores_ref(q, e[i:i + cols]) for i in
                          range(0, e.shape[0], cols)], dim=1)

    def top(s):
        idx = torch.arange(s.shape[1], device=device).expand(s.shape[0], -1)
        return select_topk(s, idx, 100)[1]

    with torch.inference_mode():
        qt = [ds.queries[q] for q in ds.queries]
        dt = [ds.corpus[d] for d in ds.corpus]
        q_full, q_shard = (encode(qt, spec.q_max_len, 256),
                           encode(qt, spec.q_max_len, 256 // shards))
        e_full, e_shard = (encode(dt, spec.p_max_len, 1024),
                           encode(dt, spec.p_max_len, 1024 // shards))
        one, per_shard = (scores(q_full, e_full, 1024),
                          scores(q_full, e_full, 1024 // shards))
        ranked = torch.sort(one, dim=1, descending=True).values[:, :101]
        emit({"phase": "fleet", "part": "c", "mode": "rounding",
              "query_rows_differ": int((q_full != q_shard).any(1).sum()),
              "corpus_rows_differ": int((e_full != e_shard).any(1).sum()),
              "scores_differ_share": float((one != per_shard).float()
                                           .mean()),
              "scores_max_diff": float((one - per_shard).abs().max()),
              "lists_moved_by_per_shard_products": int(
                  (top(one) != top(per_shard)).any(1).sum()),
              "lists": int(one.shape[0]),
              "top100_neighbour_gap_median": float(
                  (ranked[:, :-1] - ranked[:, 1:]).median())})


def fleet_serve_part(device, ds, spec, step):
    """(d) Serve phase d's 8,841,823 seeded unit rows x 768 (the same
    generator and seed, drawn on the card) in a ``ServingIndex`` on the
    four-shard mesh, ``impl="torch"``: the rows split over the shards, the
    last shard holding 1 zero pad; 10 micro-batches of 8 queries at k=10
    through ``ServingIndex.topk`` (over-request of k + 1, host pad
    filter) with ids equal to the unsharded ``topk_exact`` on the card
    and scores within 1e-5; ms per batch by CUDA events; no kernel
    launch.  The index views the f32 matrix (only the padded last shard
    is a copy), so the peak stays near 1.25 x 27.2 GB."""
    from repro_torch.core.retrieval import topk_exact
    from repro_torch.data.corpus import pad_batch
    from repro_torch.distributed import compat
    from repro_torch.models.nn import to_torch_tree
    from repro_torch.serve import ServingIndex
    from repro_torch.serve.index import place_rows
    from repro_torch.ckpt import checkpoint as ckpt
    shape, axes = FLEET_MESH
    mesh = compat.make_mesh(shape, axes, [device] * math.prod(shape))
    N, D, Q, k = MSMARCO_N, spec.dim, SERVE_BATCH, SERVE_K
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    emb = torch.randn((N, D), generator=gen, device=device)
    emb.div_(emb.norm(dim=1, keepdim=True))
    placed = place_rows(emb, mesh, axes)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    params = to_torch_tree(ckpt.restore(
        os.path.join(WORK, "ckpts"), step,
        template={"params": spec.param_shapes})[0]["params"], device)
    index = ServingIndex(step=step, params=params, doc_ids=_RowIds(N),
                         emb=placed, n_docs=N, score_dtype="f32",
                         impl="torch", block=65536, build_s=t_build,
                         mesh=mesh, axis_names=axes)
    check(index.n_pad == (-N) % mesh.devices.size == 1,
          f"fleet (d): n_pad {index.n_pad}")
    check([int(s.shape[0]) for s in placed.shards]
          == [(N + 1) // 4] * 4, "fleet (d): shard rows")
    qids = sorted(ds.queries)[:FLEET_SERVE_BATCHES * Q]
    check(len(qids) == FLEET_SERVE_BATCHES * Q, "fleet (d): too few queries")
    reset_all_launches()
    batch_ms, exact_ms, worst = [], [], 0.0
    for b in range(FLEET_SERVE_BATCHES):
        toks, mask = pad_batch([ds.queries[q] for q in
                                qids[b * Q:(b + 1) * Q]], spec.q_max_len)
        with torch.inference_mode():
            q = spec.encode_query(params, torch.from_numpy(toks).to(device),
                                  torch.from_numpy(mask).to(device))
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        gs, gi = index.topk(q, k=k)
        end.record()
        end.synchronize()
        batch_ms.append(start.elapsed_time(end))
        start.record()
        ws, wi = topk_exact(q, emb, k=k, block=65536)
        end.record()
        end.synchronize()
        exact_ms.append(start.elapsed_time(end))
        ws, wi = ws.cpu().numpy(), wi.cpu().numpy()
        check(np.array_equal(gi, wi), f"fleet (d) batch {b}: ids differ "
              "from the unsharded topk_exact")
        err = float(np.abs(gs - ws).max())
        check(err <= TOL, f"fleet (d) batch {b}: scores differ by {err:.3g}")
        worst = max(worst, err)
    counts = {key: n for key, n in all_launches().items() if n}
    check(not counts, f"fleet (d): kernel launches {counts}")
    emit({"phase": "fleet", "part": "d", "N": N, "D": D, "Q": Q, "k": k,
          "mesh": dict(mesh.shape), "n_pad": index.n_pad,
          "shard_rows": [int(s.shape[0]) for s in placed.shards],
          "batches": FLEET_SERVE_BATCHES, "max_abs_err": worst,
          "batch_ms": {"median": statistics.median(batch_ms),
                       "min": min(batch_ms), "max": max(batch_ms)},
          "unsharded_topk_exact_ms": {
              "median": statistics.median(exact_ms), "min": min(exact_ms),
              "max": max(exact_ms)},
          "build_s": t_build,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    del index, placed, emb, params


# ---------------------------------------------------------------------------
# phase 5c: the trainer and the asynchronous train -> validate loop
# ---------------------------------------------------------------------------

# dr-bert-base at full width, f32 compute, AdamW, on the main phase's data:
# 16 queries x 2 passages a step; a checkpoint every TRAIN_CKPT_EVERY steps.
# From random weights the post-LN trunk needs a warmup and a temperature
# below 1 (scores of unit vectors, scaled by 20) to learn in 240 steps.
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_BATCH = 240, 80, 16
TRAIN_PEAK_LR, TRAIN_WARMUP, TRAIN_TEMPERATURE = 3e-5, 20, 0.05
TRAIN_SEED = 11
# the first steps on the card against the CPU (2 of the 12 layers): losses
# within this relative difference
TRAIN_CPU_STEPS, TRAIN_CPU_TOL = 3, 1e-3
# the control + hand-off run (part f): a checkpoint every 40 steps, each
# handed to the validator as a host snapshot (a ring of 2), early stop on
# MRR@10 with patience 2 and a min_delta no checkpoint can beat (MRR@10
# lies in [0, 1]), so the third verdict is a plateau by construction; GC
# keeps the top 2, the soup takes the top 2
CONTROL_CKPT_EVERY, CONTROL_CAPACITY = 40, 2
CONTROL_PATIENCE, CONTROL_MIN_DELTA = 2, 1.0
CONTROL_KEEP_TOP_K, CONTROL_ENSEMBLE_TOP_K = 2, 2


def train_loss(spec):
    from repro_torch.models.biencoder import contrastive_loss
    return lambda p, b: contrastive_loss(p, spec, b,
                                         temperature=TRAIN_TEMPERATURE)


def train_optimizer():
    from repro_torch.train import optim
    return optim.adamw(optim.warmup_cosine(TRAIN_PEAK_LR, TRAIN_WARMUP,
                                           TRAIN_STEPS))


class StepClock:
    """The trainer's ``on_metrics`` hook at ``log_every=1``: the metrics
    (converted to floats, so the trainer's stream has been waited for) and
    the host time of each step, from the end of the previous step's
    bookkeeping (its callback and its ``_save``) to this step's callback;
    ``_save`` is wrapped and timed on its own.  ``after_save`` runs right
    after each save (the inline validation of Fig. 1a) and is not
    counted."""

    def __init__(self, trainer, after_save=None):
        self.trainer, self.after_save = trainer, after_save
        self.steps, self.saves = [], []
        self._mark = None
        save = trainer._save

        def timed_save():
            t0 = time.monotonic()
            save()
            self.saves.append((trainer.step, time.monotonic() - t0))
            if self.after_save is not None:
                self.after_save(trainer.step)
            self._mark = time.monotonic()

        trainer._save = timed_save

    def start(self):
        self._mark = time.monotonic()

    def __call__(self, step, m):
        self.steps.append({"step": step, "t0": self._mark,
                           "t1": time.monotonic(), **m})
        self._mark = time.monotonic()


def _validation_spans(trace_path):
    """Per checkpoint, the host interval from its discovery to the end of
    its ledger append (restore, scoring and record), and the thread that
    scored it, from the telemetry trace."""
    from repro_torch.obs import read_trace
    recs = read_trace(trace_path)
    start = {r["step"]: r["t"] for r in recs if r["name"] == "discovered"}
    out = {}
    for r in recs:
        if r["name"] == "recorded":
            out[r["step"]] = (start.get(r["step"], r["t0"]),
                              r["t0"] + r["dur"])
    scored = {r["step"]: r["tid"] for r in recs if r["name"] == "scored"}
    return out, scored


def train_run(device, ds, mode, work):
    """One run of the loop: ``"async"`` (Fig. 1b: the validator thread
    starts, the trainer runs, the validator drains) or ``"sync"`` (Fig. 1a:
    after each save, wait for it and validate inline)."""
    import dataclasses

    from repro_torch.configs import dr_bert_base
    from repro_torch.core.suite import (ValidationConfig, ValidationSuite,
                                        ValidationTask)
    from repro_torch.core.validator import (CKPT_TO_VERDICT_METRIC,
                                            AsyncValidator)
    from repro_torch.launch.train import _contrastive_batches
    from repro_torch.models import transformer as tfm
    from repro_torch.models.biencoder import biencoder_spec
    from repro_torch.obs import Telemetry
    from repro_torch.train.trainer import Trainer, TrainerConfig
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = dataclasses.replace(dr_bert_base.full_config(),
                              compute_dtype=torch.float32)
    spec = biencoder_spec(cfg, q_max_len=32, p_max_len=128, device=device)
    trace = os.path.join(work, "trace.jsonl")
    tel = Telemetry(trace, process=mode)
    vcfg = ValidationConfig(metrics=("MRR@10", "Recall@100"), k=100,
                            batch_size=256, chunk_size=1024, impl="cuda",
                            score_dtype="f32", write_run=True,
                            output_dir=os.path.join(work, "runs"),
                            telemetry=tel)
    suite = ValidationSuite(spec, [ValidationTask(
        "default", ds.corpus, ds.queries, ds.qrels)], vcfg)
    suite.build_engines()
    ckdir = os.path.join(work, "ckpts")
    ledger = os.path.join(work, "ledger.jsonl")
    validator = AsyncValidator(ckdir, suite, telemetry=tel,
                               ledger_path=ledger, poll_interval_s=0.05)
    params = tfm.params_from_numpy(tfm.init_numpy(cfg, TRAIN_SEED), device)
    trainer = Trainer(
        TrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
                      ckpt_dir=ckdir, log_every=1),
        train_loss(spec), train_optimizer(), params,
        _contrastive_batches(ds, spec, TRAIN_BATCH), telemetry=tel)

    def inline(step):
        trainer.saver.wait()
        validator.validate_pending()

    clock = StepClock(trainer, after_save=inline if mode == "sync" else None)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    clock.start()
    if mode == "async":
        validator.start()
        trainer.run(on_metrics=clock)
        validator.stop(drain=True)
    else:
        trainer.run(on_metrics=clock)
        validator.validate_pending()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: n for k, n in all_launches().items() if n}
    tel.flush()
    check(not validator.errors, f"{mode}: validation errors "
          f"{list(validator.errors)}")
    with open(ledger) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    saved = list(range(TRAIN_CKPT_EVERY, TRAIN_STEPS + 1, TRAIN_CKPT_EVERY))
    check([r["step"] for r in rows] == saved,
          f"{mode}: ledger steps {[r['step'] for r in rows]}, saved {saved}")
    for r in rows:
        check(set(r) == LEDGER_KEYS, f"{mode}: ledger keys {sorted(r)}")
        check(all(math.isfinite(v) for v in r["metrics"].values()),
              f"{mode}: metrics {r['metrics']}")
    hist = tel.metrics.get(CKPT_TO_VERDICT_METRIC)
    check(hist is not None and hist.count == len(saved),
          f"{mode}: {hist.count if hist else 0} checkpoint-to-verdict "
          f"observations for {len(saved)} checkpoints")
    spans, scored_tid = _validation_spans(trace)
    alone, busy = [], []
    train_s = sum(st["t1"] - st["t0"] for st in clock.steps)
    for st in clock.steps[1:]:              # the first step warms up
        ms = (st["t1"] - st["t0"]) * 1e3
        overlap = any(a < st["t1"] and st["t0"] < b
                      for a, b in spans.values())
        (busy if overlap else alone).append(ms)
    losses = [st["loss"] for st in clock.steps]
    from repro_torch.core.metrics import read_trec_run
    runs = {step: read_trec_run(os.path.join(
        work, "runs", f"asyncval_step{step}.trec")) for step in saved}
    return {"mode": mode, "rows": rows, "runs": runs, "wall_s": wall,
            "train_s": train_s,
            "launches": counts, "losses": losses,
            "first": clock.steps[0], "last": clock.steps[-1],
            "step_ms_alone": alone, "step_ms_with_validation": busy,
            "save_s": [t for _, t in clock.saves],
            "verdict_s": {"p50": hist.percentile(50), "max": hist.vmax},
            "validation_s": {s: b - a for s, (a, b) in spans.items()},
            "scored_tids": scored_tid, "trainer": trainer,
            "ckdir": ckdir}


def _summary(run):
    med = (lambda xs: statistics.median(xs) if xs else None)
    return {"mode": run["mode"], "wall_s": run["wall_s"],
            "train_s": run["train_s"], "launches": run["launches"],
            "step_ms_median_alone": med(run["step_ms_alone"]),
            "step_ms_median_with_validation":
                med(run["step_ms_with_validation"]),
            "steps_alone": len(run["step_ms_alone"]),
            "steps_with_validation": len(run["step_ms_with_validation"]),
            "save_s_in_training_thread": run["save_s"],
            "ckpt_to_verdict_s": run["verdict_s"],
            "validation_s": run["validation_s"],
            "total_s_ledger": {r["step"]: r["timings"]["total_s"]
                               for r in run["rows"]},
            "first": {k: run["first"][k] for k in
                      ("step", "loss", "contrastive_acc")},
            "last": {k: run["last"][k] for k in
                     ("step", "loss", "contrastive_acc")},
            "mrr10": {r["step"]: r["metrics"]["MRR@10"]
                      for r in run["rows"]}}


def control_run(device, ds, work):
    """(f) The control plane and the snapshot hand-off on the async loop,
    through ``repro_torch.launch.train``'s pieces (``make_handoff``,
    ``make_control``, ``drive``): the trainer publishes each checkpoint's
    params as a host snapshot, the validator thread scores it before the
    durable save commits, the control plane ranks it, deletes checkpoints
    outside the top 2 once their evidence is durable, writes the STOP
    marker on the plateau and, after the drain, soups the top 2 into a
    virtual checkpoint that is validated like the others.  Gated: the STOP
    marker's verdict is a plateau written from the validator thread; the
    trainer stopped before its last step; GC deleted at least one
    checkpoint and only validated ones; the soup is committed and
    ledgered; the snapshot-scored rows are the published and not dropped
    steps, and their metrics and top-k lists equal a durable re-validation
    in a fresh ledger; replaying the ledger gives the online decisions byte
    for byte; the channel holds nothing at the end."""
    import dataclasses

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import dr_bert_base
    from repro_torch.control import (ControlEventLog, replay_ledger,
                                     stop_requested)
    from repro_torch.obs import read_trace
    from repro_torch.core.metrics import read_trec_run
    from repro_torch.core.suite import (ValidationConfig, ValidationSuite,
                                        ValidationTask)
    from repro_torch.core.validator import (CKPT_TO_VERDICT_METRIC,
                                            AsyncValidator)
    from repro_torch.launch.train import (_contrastive_batches, drive,
                                          make_control, make_handoff)
    from repro_torch.models import transformer as tfm
    from repro_torch.models.biencoder import biencoder_spec
    from repro_torch.obs import Telemetry
    from repro_torch.train.trainer import Trainer, TrainerConfig
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_part = time.perf_counter()
    cfg = dataclasses.replace(dr_bert_base.full_config(),
                              compute_dtype=torch.float32)
    spec = biencoder_spec(cfg, q_max_len=32, p_max_len=128, device=device)
    trace = os.path.join(work, "trace.jsonl")
    tel = Telemetry(trace, process="control")

    def make_suite(runs_dir, telemetry):
        vcfg = ValidationConfig(metrics=("MRR@10", "Recall@100"), k=100,
                                batch_size=256, chunk_size=1024,
                                impl="cuda", score_dtype="f32",
                                write_run=True, output_dir=runs_dir,
                                telemetry=telemetry)
        suite = ValidationSuite(spec, [ValidationTask(
            "default", ds.corpus, ds.queries, ds.qrels)], vcfg)
        suite.build_engines()
        return suite

    suite = make_suite(os.path.join(work, "runs"), tel)
    ckdir = os.path.join(work, "ckpts")
    stop_file = os.path.join(work, "STOP")
    snapshots = make_handoff(True, CONTROL_CAPACITY, telemetry=tel)
    control = make_control(ckdir, work, patience=CONTROL_PATIENCE,
                           min_delta=CONTROL_MIN_DELTA,
                           keep_top_k=CONTROL_KEEP_TOP_K,
                           ensemble_top_k=CONTROL_ENSEMBLE_TOP_K,
                           snapshots=snapshots, telemetry=tel)
    validator = AsyncValidator(ckdir, suite, telemetry=tel,
                               controller=control, snapshots=snapshots,
                               ledger_path=os.path.join(work, "ledger.jsonl"),
                               poll_interval_s=0.05)
    published, held = [], [0]

    def on_publish(step):
        published.append(step)
        held[0] = max(held[0], snapshots.nbytes())

    snapshots.subscribe(on_publish)
    stopped_by = {}
    trigger = control.earlystop._trigger

    def traced_trigger(step, reason):
        stopped_by["tid"] = threading.get_ident()
        trigger(step, reason)

    control.earlystop._trigger = traced_trigger
    params = tfm.params_from_numpy(tfm.init_numpy(cfg, TRAIN_SEED), device)
    trainer = Trainer(
        TrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=CONTROL_CKPT_EVERY,
                      ckpt_dir=ckdir, log_every=1, stop_file=stop_file,
                      snapshots=snapshots),
        train_loss(spec), train_optimizer(), params,
        _contrastive_batches(ds, spec, TRAIN_BATCH), telemetry=tel)
    history = []
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    ensemble = drive(trainer, validator, suite, control, sync=False,
                     ckpt_every=CONTROL_CKPT_EVERY,
                     on_metrics=lambda step, m: history.append(
                         (step, m["loss"])))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: n for k, n in all_launches().items() if n}
    tel.flush()
    check(not validator.errors, f"control: validation errors "
          f"{list(validator.errors)}")
    with open(os.path.join(work, "ledger.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    steps = [r["step"] for r in rows]
    verdict = stop_requested(stop_file)
    main_tid = threading.get_ident()
    check(verdict is not None and verdict["reason"] == "plateau"
          and stopped_by.get("tid") not in (None, main_tid),
          f"control: STOP marker {verdict}, written on thread "
          f"{stopped_by.get('tid')} (main {main_tid})")
    check(trainer.stopped_early and trainer.step < TRAIN_STEPS,
          f"control: the trainer ran to step {trainer.step} "
          f"(stopped early: {trainer.stopped_early})")
    events = ControlEventLog(os.path.join(work, "control.jsonl")).events()
    deleted = sorted(s for e in events if e.kind == "gc"
                     for s in e.payload["deleted"])
    check(deleted and set(deleted) <= set(steps),
          f"control: GC deleted {deleted}; validated {steps}")
    check(ensemble is not None and ensemble["step"] in steps
          and ensemble["step"] in ckpt.list_steps(ckdir)
          and ckpt.read_extra(ckdir, ensemble["step"]).get("virtual"),
          f"control: soup {ensemble}, ledger steps {steps}")
    snap_rows = [r["step"] for r in rows if r.get("handoff") == "snapshot"]
    want_snap = [s for s in published if s not in snapshots.dropped]
    check(snap_rows and sorted(snap_rows) == sorted(want_snap),
          f"control: snapshot-scored rows {snap_rows}, published "
          f"{published}, dropped {snapshots.dropped}")
    check(snapshots.nbytes() == 0, f"control: the channel still holds "
          f"{snapshots.nbytes()} bytes")
    online = [e.to_json() for e in ControlEventLog(
        os.path.join(work, "control.jsonl")).decisions()]
    replayed = [e.to_json() for e in replay_ledger(
        rows, control.cfg, train_history=history).events.decisions()]
    check(online and replayed == online, f"control: replay gives "
          f"{len(replayed)} decisions, online {len(online)}; "
          f"equal: {replayed == online}")
    hist = tel.metrics.get(CKPT_TO_VERDICT_METRIC)
    # checkpoint-to-verdict of the trained checkpoints (the soup has no
    # trainer mark): from the trainer's `produced` event to the end of the
    # step's ledger append
    recs = read_trace(trace)
    produced = {r["step"]: r["t"] for r in recs if r["name"] == "produced"}
    verdict_s = sorted(r["t0"] + r["dur"] - produced[r["step"]]
                       for r in recs if r["name"] == "recorded"
                       and r["step"] in produced)
    spans, scored_tid = _validation_spans(trace)
    on_thread = sum(tid != main_tid for tid in scored_tid.values())
    check(counts.get("topk_mips_f32", 0) > 0 and on_thread > 0,
          f"control: topk_mips launches {counts}, {on_thread} checkpoints "
          "scored on the validator thread")
    # the snapshot-scored steps still on disk, validated again from their
    # durable checkpoints in a fresh ledger
    again = [s for s in snap_rows if s in ckpt.list_steps(ckdir)]
    check(bool(again), f"control: no snapshot-scored step left on disk "
          f"({snap_rows}, kept {ckpt.list_steps(ckdir)})")
    durable = AsyncValidator(ckdir, make_suite(os.path.join(work,
                                                            "runs_durable"),
                                               None),
                             ledger_path=os.path.join(work, "durable.jsonl"))
    for s in again:
        durable.validate_step(s)
    check(not durable.errors, f"control: re-validation {durable.errors}")
    redo = {r["step"]: r["metrics"] for r in durable.ledger.rows()}
    first = {r["step"]: r["metrics"] for r in rows}
    lists = differ = 0
    for s in again:
        a = read_trec_run(os.path.join(work, "runs",
                                       f"asyncval_step{s}.trec"))
        b = read_trec_run(os.path.join(work, "runs_durable",
                                       f"asyncval_step{s}.trec"))
        lists += len(a)
        differ += sum(1 for qid in a if a[qid] != b.get(qid))
    metrics_equal = all(redo[s] == first[s] for s in again)
    check(metrics_equal and differ == 0, f"control: snapshot vs durable "
          f"metrics equal {metrics_equal}, {differ} of {lists} lists differ")
    host_stats = getattr(torch.cuda, "host_memory_stats", None)
    emit({"phase": "train", "part": "f", "entry": "control + hand-off",
          "wall_s": wall, "seconds": time.perf_counter() - t_part,
          "ckpt_every": CONTROL_CKPT_EVERY, "capacity": CONTROL_CAPACITY,
          "last_step": trainer.step, "stop_verdict": verdict,
          "stop_written_on_validator_thread": True,
          "ledger_steps": steps, "snapshot_scored": snap_rows,
          "published": published, "dropped": snapshots.dropped,
          "gc_deleted": deleted, "kept": ckpt.list_steps(ckdir),
          "ensemble": ensemble, "launches": counts,
          "validator_thread_scored": on_thread,
          "ckpt_to_verdict_s": {"p50": statistics.median(verdict_s),
                                "max": verdict_s[-1],
                                "count": len(verdict_s),
                                "histogram_p50_with_soup":
                                    hist.percentile(50)},
          "pinned_bytes_held_peak": held[0],
          # pinned blocks the caching host allocator holds (for reuse)
          "host_allocated_bytes": {k: v for k, v in host_stats().items()
                                   if k.startswith("allocated_bytes.")
                                   and k.endswith(("current", "peak"))}
          if host_stats else None,
          "revalidated": again, "lists": lists, "lists_differ": differ,
          "metrics_equal": metrics_equal,
          "decisions": len(online), "replay_equal": True,
          "total_s_ledger": {r["step"]: r["timings"]["total_s"]
                             for r in rows},
          "mrr10": {r["step"]: r["metrics"]["MRR@10"] for r in rows}})
    shutil.rmtree(ckdir, ignore_errors=True)


def train_cpu_part(device, ds):
    """(a) The first steps of the trainer on the card and on the CPU from
    the same initial params and batches, dr-bert-base cut to 2 layers."""
    import dataclasses

    from repro_torch.configs import dr_bert_base
    from repro_torch.launch.train import _contrastive_batches
    from repro_torch.models import transformer as tfm
    from repro_torch.models.biencoder import biencoder_spec
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(dr_bert_base.full_config(), n_layers=2,
                              compute_dtype=torch.float32)
    tree = tfm.init_numpy(cfg, TRAIN_SEED)
    losses = {}
    for name, where in (("card", device), ("cpu", torch.device("cpu"))):
        spec = biencoder_spec(cfg, q_max_len=32, p_max_len=128, device=where)
        tr = Trainer(TrainerConfig(total_steps=TRAIN_CPU_STEPS, log_every=1),
                     train_loss(spec), train_optimizer(),
                     tfm.params_from_numpy(tree, where),
                     _contrastive_batches(ds, spec, TRAIN_BATCH))
        losses[name] = [m["loss"] for _, m in tr.run()]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                   losses["cpu"]))
    check(rel <= TRAIN_CPU_TOL, f"train: card vs CPU losses differ by "
          f"{rel:.3g} relative ({losses})")
    emit({"phase": "train", "part": "a", "layers": cfg.n_layers,
          "losses": losses, "max_rel_diff": rel, "gate": TRAIN_CPU_TOL})


def train_phase(device, ds, trace: bool = False):
    """(a) card vs CPU, (b) the async loop (Fig. 1b), (c) the sync loop
    (Fig. 1a), both gated, (f) the control plane and the hand-off on the
    async loop, (d) a port checkpoint restored through the port, (e)
    ``python -m repro_torch.launch.train`` on its smoke config, and the
    fidelity of the splitter's subset on the trained checkpoints; with
    ``trace``, a profile of a few training steps.  The loops run under
    ``torch.use_deterministic_algorithms`` (with the cuBLAS workspace
    setting it asks for), so async and sync must give equal metrics."""
    from repro_torch.core import pytree
    t_phase = time.perf_counter()
    train_cpu_part(device, ds)
    saved_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    fill = torch.utils.deterministic.fill_uninitialized_memory
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    # nothing reads memory it did not write; the fill would only add
    # memsets, and a 1.3 GB pinned buffer fill per save on the host
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        runs = {mode: train_run(device, ds, mode,
                                os.path.join(WORK, f"train_{mode}"))
                for mode in ("async", "sync")}
        control_run(device, ds, os.path.join(WORK, "train_control"))
        if trace:
            train_trace(device, ds, "train_3_steps_deterministic")
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        if saved_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved_env
    a, s = runs["async"], runs["sync"]
    main_tid = threading.get_ident()
    on_thread = sum(tid != main_tid for tid in a["scored_tids"].values())
    lists = sum(1 for step, run in a["runs"].items()
                for qid, ranked in run.items()
                if ranked != s["runs"][step][qid])
    diff = max(abs(v - rs["metrics"][m]) for ra, rs in zip(a["rows"],
                                                           s["rows"])
               for m, v in ra["metrics"].items())
    params_equal = all(torch.equal(x, y) for x, y in zip(
        pytree.tree_leaves(a["trainer"].params),
        pytree.tree_leaves(s["trainer"].params)))
    for part, run in (("b", a), ("c", s)):
        emit({"phase": "train", "part": part, **_summary(run),
              "validator_thread_scored": on_thread if run is a else None})
    emit({"phase": "train", "part": "async_vs_sync",
          "deterministic_algorithms": True, "max_metric_diff": diff,
          "lists_differ": lists,
          "lists": sum(len(r) for r in a["runs"].values()),
          "final_params_equal": params_equal,
          "wall_s": {"async": a["wall_s"], "sync": s["wall_s"]}})
    check(a["launches"].get("topk_mips_f32", 0) > 0 and on_thread > 0,
          f"async: topk_mips launches {a['launches']}, {on_thread} "
          "checkpoints scored on the validator thread")
    for run in (a, s):
        first, last = run["losses"][:10], run["losses"][-10:]
        check(sum(last) < sum(first), f"{run['mode']}: the loss did not "
              f"fall ({sum(first) / 10:.4f} -> {sum(last) / 10:.4f})")
    check(diff == 0.0, f"async vs sync: metrics differ by {diff:.3g} "
          "under deterministic algorithms")
    restore_part(a)
    launch_part()
    fidelity_part(device, ds, a)
    if trace:
        train_trace(device, ds, "train_3_steps")
    emit({"phase": "train", "ok": True,
          "seconds": time.perf_counter() - t_phase})
    for run in runs.values():
        shutil.rmtree(run["ckdir"], ignore_errors=True)
    # the trainers' states sit in reference cycles (the timed _save); free
    # them and their cached blocks before the LM phase's large allocations
    del runs, a, s
    gc.collect()
    torch.cuda.empty_cache()


def restore_part(run):
    """(d) The async run's last checkpoint restored through the port's
    reader: params and AdamW state, every leaf equal to the trainer's."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.core import pytree
    tr = run["trainer"]
    state = {"params": tr.params, "opt_state": tr.opt_state}
    got, extra = ckpt.restore(run["ckdir"], TRAIN_STEPS,
                              template=pytree.tree_map(
                                  lambda t: tuple(t.shape), state))
    want = pytree.tree_leaves(state)
    have = pytree.tree_leaves(got)
    check(len(want) == len(have) and all(
        torch.equal(x.cpu(), y) for x, y in zip(want, have)),
        "restored checkpoint differs from the trainer's state")
    with open(os.path.join(ckpt._step_dir(run["ckdir"], TRAIN_STEPS),
                           "manifest.json")) as f:
        manifest = json.load(f)
    check(bool(manifest["treedef"]) and extra["step"] == TRAIN_STEPS,
          "port checkpoint lacks its treedef or step")
    emit({"phase": "train", "part": "d", "step": TRAIN_STEPS,
          "leaves": len(have), "equal": True,
          "bytes": sum(t.numel() * t.element_size() for t in have)})


def launch_part():
    """(e) ``python -m repro_torch.launch.train`` (smoke config, the
    reference's defaults but 20 steps) on the card."""
    work = os.path.join(WORK, "train_launch")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--workdir", work,
         "--steps", "20", "--ckpt-every", "5"],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"launch.train failed: {proc.stderr[-2000:]}")
    with open(os.path.join(work, "summary.json")) as f:
        summary = json.load(f)
    check(summary["validated_steps"] == [5, 10, 15, 20]
          and not summary["errors"] and summary["mode"] == "async",
          f"launch.train: {summary}")
    emit({"phase": "train", "part": "e", "entry": "repro_torch.launch.train",
          "validated_steps": summary["validated_steps"],
          "wall_time_s": summary["wall_time_s"], "seconds": seconds,
          "metrics": summary["metrics"]})


def fidelity_part(device, ds, run):
    """(f) The splitter's subset (subset phase a) against the full corpus
    on the trained checkpoints of the async run: MRR@10 from the same
    validator config, Pearson and Kendall."""
    import dataclasses

    from repro_torch.configs import dr_bert_base
    from repro_torch.core import fidelity
    from repro_torch.core.suite import (ValidationConfig, ValidationSuite,
                                        ValidationTask)
    from repro_torch.core.validator import AsyncValidator
    from repro_torch.data import corpus as corpus_lib
    from repro_torch.models.biencoder import biencoder_spec
    cfg = dataclasses.replace(dr_bert_base.full_config(),
                              compute_dtype=torch.float32)
    spec = biencoder_spec(cfg, q_max_len=32, p_max_len=128, device=device)
    kept = corpus_lib.read_jsonl(os.path.join(
        WORK, "subset", f"subset_top{SUBSET_DEPTH}.jsonl"))
    vcfg = ValidationConfig(metrics=("MRR@10", "Recall@100"), k=100,
                            batch_size=256, chunk_size=1024, impl="cuda",
                            score_dtype="f32")
    suite = ValidationSuite(spec, [ValidationTask(
        "default", kept, ds.queries, ds.qrels)], vcfg)
    validator = AsyncValidator(run["ckdir"], suite)
    validator.validate_pending()
    check(not validator.errors, f"fidelity: {list(validator.errors)}")
    steps = [r["step"] for r in run["rows"]]
    full = [r["metrics"]["MRR@10"] for r in run["rows"]]
    sub = {r.step: r.metrics["MRR@10"] for r in validator.results}
    est = [sub[s] for s in steps]
    report = fidelity.fidelity_report(full, est)
    emit({"phase": "subset", "part": "f", "weights": "trained",
          "metric": "MRR@10", "steps": steps, "full": full, "subset": est,
          "subset_size": len(kept), "report": report})


def train_trace(device, ds, name):
    """Three training steps at the phase's shapes under the profiler."""
    import dataclasses

    from repro_torch.configs import dr_bert_base
    from repro_torch.launch.train import _contrastive_batches
    from repro_torch.models import transformer as tfm
    from repro_torch.models.biencoder import biencoder_spec
    from repro_torch.train.trainer import make_train_step
    cfg = dataclasses.replace(dr_bert_base.full_config(),
                              compute_dtype=torch.float32)
    spec = biencoder_spec(cfg, q_max_len=32, p_max_len=128, device=device)
    opt = train_optimizer()
    step = make_train_step(train_loss(spec), opt)
    batches = _contrastive_batches(ds, spec, TRAIN_BATCH)
    state = [tfm.params_from_numpy(tfm.init_numpy(cfg, TRAIN_SEED), device)]
    state.append(opt.init(state[0]))
    state[0], state[1], _ = step(state[0], state[1], batches(0))   # warm

    def three():
        for i in range(3):
            state[0], state[1], m = step(state[0], state[1], batches(1 + i))
        float(m["loss"])

    emit(traced(name, three, ("gemm", "nvjet", "xmma")))


# ---------------------------------------------------------------------------
# phase 6: the dense LM family at full width
# ---------------------------------------------------------------------------

# gates of the LM phase: "cuda" (flash kernel, split p) against "torch" (the
# chunked path, p cast to the compute dtype) on the card; the card against
# the CPU; prefill (cached, chunked path) against the no-cache flash forward
LM_GATES = {"loss": {"f32": 1e-4, "bf16": 2e-2},
            "hidden_err": {"f32": 2e-3}, "hidden_cos": {"bf16": 0.99},
            "cpu_hidden_err": 2e-3, "cpu_loss": 1e-4, "prefill_logits": 1e-3,
            "decode_logits": 1e-3}
# the decode_step parts: qwen2-0.5b at decode_32k (its published batch and
# cache), and qwen2-72b at full width with 2 of its 80 layers, batch 16
DECODE_32K = {"batch": 128, "cache": 32768}
QWEN72_DECODE = {"batch": 16, "cache": 32768}
QWEN72_LAYERS = 2
# timed calls of each LM entry point after its first (warm-up) call
LM_REPEATS = 5


def reset_all_launches():
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.topk_mips import ops as topk_ops
    decode_ops.reset_launches()
    flash_ops.reset_launches()
    topk_ops.reset_launches()


def all_launches():
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.topk_mips import ops as topk_ops
    return {**{f"topk_mips_{k}": n for k, n in topk_ops.launches.items()},
            **{f"flash_attention_{k}": n
               for k, n in flash_ops.launches.items()},
            **{f"decode_attention_{k}": n
               for k, n in decode_ops.launches.items()}}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def call_times_ms(fn, n: int = LM_REPEATS) -> dict:
    """``n`` calls of ``fn`` (already warmed up by the caller), each timed
    between two CUDA events on the current stream: host issue and device
    work until the call's last kernel ends.  Median, least and most."""
    ms = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms),
            "n": n}


def row_cosines(a, b) -> torch.Tensor:
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))


def row_cosine(a, b) -> float:
    return float(row_cosines(a, b).min())


def lm_phase(device, trace: bool = False):
    import dataclasses

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import qwen2_0_5b
    from repro_torch.launch import lm_demo
    from repro_torch.models import transformer as tfm
    t_phase = time.perf_counter()
    full = qwen2_0_5b.full_config()
    t0 = time.perf_counter()
    tree = tfm.init_numpy(full, 13)
    params = tfm.params_from_numpy(tree, device)
    torch.cuda.synchronize()
    n_params = sum(a.size for _, a in ckpt.flatten(tree))
    emit({"phase": "lm", "setup": "params", "config": full.name,
          "n_params": n_params, "seconds": time.perf_counter() - t0})
    rng = np.random.default_rng(13)
    B, S = 4, 2048
    tokens = torch.from_numpy(rng.integers(1, full.vocab_size, (B, S))
                              .astype(np.int32)).to(device)

    # (a) lm_loss and forward, flash kernel against the chunked path
    measured = {}
    for dt in ("f32", "bf16"):
        out = {}
        for impl in ("cuda", "torch"):
            cfg = dataclasses.replace(full, compute_dtype=TORCH_DT[dt],
                                      attn_impl=impl)
            with torch.inference_mode():
                # each entry point's first call is counted and checked; it
                # warms the config up for the timed calls after it
                reset_all_launches()
                loss, aux = tfm.lm_loss(params, cfg, {"tokens": tokens})
                loss_launches = all_launches()
                loss_ms = call_times_ms(
                    lambda: tfm.lm_loss(params, cfg, {"tokens": tokens}))
                reset_all_launches()
                hidden, _, _ = tfm.forward(params, cfg, tokens)
                fwd_launches = all_launches()
                fwd_ms = call_times_ms(
                    lambda: tfm.forward(params, cfg, tokens))
            want = {key: 0 for key in loss_launches}
            if impl == "cuda":
                want[f"flash_attention_{dt}"] = full.n_layers
            check(loss_launches == want and fwd_launches == want,
                  f"lm {dt}/{impl}: launches {loss_launches} (lm_loss), "
                  f"{fwd_launches} (forward), expected {want}")
            check(hidden.shape == (B, S, full.d_model)
                  and bool(torch.isfinite(hidden).all())
                  and math.isfinite(float(loss)),
                  f"lm {dt}/{impl}: non-finite loss or hidden")
            if impl == "cuda":
                measured[dt] = loss_launches[f"flash_attention_{dt}"]
            out[impl] = {"loss": float(loss), "hidden": hidden,
                         "lm_loss_ms": loss_ms, "forward_ms": fwd_ms,
                         "launches": loss_launches}
        a, b = out["cuda"], out["torch"]
        loss_diff = abs(a["loss"] - b["loss"])
        err = float((a["hidden"].float() - b["hidden"].float()).abs().max())
        cos = row_cosine(a["hidden"], b["hidden"])
        check(loss_diff <= LM_GATES["loss"][dt],
              f"lm {dt}: loss cuda {a['loss']} vs torch {b['loss']}")
        if dt == "f32":
            check(err <= LM_GATES["hidden_err"][dt],
                  f"lm {dt}: hidden differs by {err:.3g}")
        else:
            check(cos >= LM_GATES["hidden_cos"][dt],
                  f"lm {dt}: hidden row cosine {cos}")
        emit({"phase": "lm", "part": "a", "compute_dtype": dt, "B": B,
              "S": S, "loss_cuda": a["loss"], "loss_torch": b["loss"],
              "loss_diff": loss_diff, "loss_gate": LM_GATES["loss"][dt],
              "hidden_max_abs_err": err, "hidden_min_row_cos": cos,
              "hidden_gate": LM_GATES["hidden_err"].get(dt,
                                                         LM_GATES["hidden_cos"]
                                                         .get(dt)),
              "ms": {impl: {"lm_loss": out[impl]["lm_loss_ms"],
                            "forward": out[impl]["forward_ms"]}
                     for impl in out},
              "launches": {impl: out[impl]["launches"] for impl in out}})
        del out, a, b
    if trace:
        for dt in ("f32", "bf16"):
            cfg = dataclasses.replace(full, compute_dtype=TORCH_DT[dt],
                                      attn_impl="cuda")
            with torch.inference_mode():
                emit(traced(f"lm_forward_{dt}",
                            lambda: tfm.forward(params, cfg, tokens),
                            ("flash_fwd",)))

    # (b) the card against the CPU: full width, 2 layers, S=256, f32
    cfg2 = dataclasses.replace(full, n_layers=2, compute_dtype=torch.float32,
                               attn_impl="cuda")
    tree2 = dict(tree, dense_layers={
        key: {k: v[:2] for k, v in sub.items()}
        for key, sub in tree["dense_layers"].items()})
    toks2 = tokens[:2, :256]
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu_params = tfm.params_from_numpy(tree2)
        cpu_h = tfm.forward(cpu_params, cfg2, toks2.cpu())[0]
        cpu_loss = float(tfm.lm_loss(cpu_params, cfg2,
                                     {"tokens": toks2.cpu()})[0])
        gpu_params = tfm.params_from_numpy(tree2, device)
        gpu_h = tfm.forward(gpu_params, cfg2, toks2)[0].cpu()
        gpu_loss = float(tfm.lm_loss(gpu_params, cfg2, {"tokens": toks2})[0])
    err = float((gpu_h - cpu_h).abs().max())
    check(err <= LM_GATES["cpu_hidden_err"] and
          abs(gpu_loss - cpu_loss) <= LM_GATES["cpu_loss"],
          f"lm card vs CPU: hidden {err:.3g}, loss {gpu_loss} vs {cpu_loss}")
    emit({"phase": "lm", "part": "b", "layers": 2, "S": 256,
          "hidden_max_abs_err": err, "gate": LM_GATES["cpu_hidden_err"],
          "loss_card": gpu_loss, "loss_cpu": cpu_loss,
          "seconds": time.perf_counter() - t0})
    del cpu_params, gpu_params

    # (c) serve_batch: prefill (chunked path) + greedy decode, whose steps
    # go through the decode kernel under "cuda"
    P, G = 128, 16
    prompts = tokens[:, :P].contiguous()
    per_call = full.n_layers * (G - 1)
    serve = {}
    for impl in ("cuda", "torch"):
        cfg = dataclasses.replace(full, attn_impl=impl)
        lm_demo.serve_batch(params, cfg, prompts, G)          # warm-up
        reset_all_launches()
        serve_s = []
        for _ in range(3):
            gen, seconds = timed(
                lambda: lm_demo.serve_batch(params, cfg, prompts, G))
            serve_s.append(seconds)
        serve_launches = all_launches()
        want = {key: 0 for key in serve_launches}
        if impl == "cuda":
            want["decode_attention_bf16"] = 3 * per_call
            measured["decode_bf16"] = serve_launches["decode_attention_bf16"]
        check(serve_launches == want, f"serve_batch {impl}: launches "
              f"{serve_launches}, expected {want}")
        check(gen.shape == (B, G) and gen.dtype == torch.int32
              and bool(((gen >= 0) & (gen < full.vocab_size)).all()),
              f"serve_batch returned {tuple(gen.shape)} {gen.dtype}")
        serve[impl] = {"seconds": serve_s,
                       "tokens_per_s": B * G / statistics.median(serve_s),
                       "tokens_per_s_min_max": [B * G / max(serve_s),
                                                B * G / min(serve_s)],
                       "launches_per_call": {k: n // 3 for k, n in
                                             serve_launches.items() if n},
                       "sample": gen[0].tolist()}
    # at f32: equal greedy tokens, teacher-forced decode logits of the two
    # impls, and the kernel's last step against the no-cache flash forward
    cfg32 = {impl: dataclasses.replace(full, attn_impl=impl,
                                       compute_dtype=torch.float32)
             for impl in ("cuda", "torch")}
    reset_all_launches()
    gen32 = lm_demo.serve_batch(params, cfg32["cuda"], prompts, G)
    f32_launches = all_launches()
    check(f32_launches["decode_attention_f32"] == per_call,
          f"f32 serve_batch: launches {f32_launches}, expected {per_call} "
          "decode_attention_f32")
    measured["decode_f32"] = f32_launches["decode_attention_f32"]
    gen32_torch = lm_demo.serve_batch(params, cfg32["torch"], prompts, G)
    check(torch.equal(gen32, gen32_torch), "f32 serve_batch tokens differ "
          f"between impls: {gen32[0].tolist()} vs {gen32_torch[0].tolist()}")
    step_err = 0.0
    with torch.inference_mode():
        caches = {impl: tfm.prefill(params, cfg32[impl], prompts,
                                    max_len=P + G)[1] for impl in cfg32}
        for i in range(G - 1):
            tok = gen32[:, i:i + 1]
            lg = {impl: tfm.decode_step(params, cfg32[impl], caches[impl],
                                        tok, P + i)[0] for impl in cfg32}
            step_err = max(step_err, float((lg["cuda"] - lg["torch"])
                                           .abs().max()))
        seq = torch.cat([prompts, gen32[:, :G - 1]], dim=1)
        hid = tfm.forward(params, cfg32["cuda"], seq)[0]
        nocache = tfm.logits(params, cfg32["cuda"], hid[:, -1:])
        flash_err = float((lg["cuda"] - nocache).abs().max())
        pre, _ = tfm.prefill(params, cfg32["cuda"], prompts, max_len=P + G)
        hid = tfm.forward(params, cfg32["cuda"], prompts)[0]
        pre_err = float((pre - tfm.logits(params, cfg32["cuda"],
                                          hid[:, -1:])).abs().max())
    del caches
    gate = LM_GATES["decode_logits"]
    check(step_err <= gate, f"f32 decode-step logits differ between impls "
          f"by {step_err:.3g}")
    check(flash_err <= gate, f"f32 last decode-step logits differ from the "
          f"no-cache flash forward by {flash_err:.3g}")
    check(pre_err <= LM_GATES["prefill_logits"],
          f"prefill logits differ from the no-cache flash forward by "
          f"{pre_err:.3g}")
    emit({"phase": "lm", "part": "c", "batch": B, "prompt": P, "gen": G,
          "serve": serve, "f32_decode_launches": per_call,
          "f32_tokens_equal": True,
          "f32_step_logits_max_abs_err": step_err,
          "f32_last_step_vs_flash_logits_max_abs_err": flash_err,
          "prefill_vs_flash_logits_max_abs_err": pre_err,
          "gates": {"decode_logits": gate,
                    "prefill_logits": LM_GATES["prefill_logits"]}})

    # (d) one decode_step of full-width qwen2-0.5b at decode_32k
    del tokens
    decode_step_part("d", device, params, full, DECODE_32K, trace=trace)
    del params
    torch.cuda.empty_cache()
    # (e) the same step on qwen2-72b at full width, depth cut to 2 layers
    from repro_torch.configs import qwen2_72b
    cfg72 = dataclasses.replace(qwen2_72b.full_config(),
                                n_layers=QWEN72_LAYERS)
    t0 = time.perf_counter()
    params72 = device_params(cfg72, 72, device)
    emit({"phase": "lm", "setup": "params", "config": cfg72.name,
          "layers": cfg72.n_layers, "of_layers":
          qwen2_72b.full_config().n_layers,
          "n_params": sum(t.numel() for _, t in ckpt.flatten(params72)),
          "seconds": time.perf_counter() - t0})
    decode_step_part("e", device, params72, cfg72, QWEN72_DECODE)
    del params72
    torch.cuda.empty_cache()
    emit({"phase": "lm", "ok": True,
          "seconds": time.perf_counter() - t_phase})
    return measured


# ---------------------------------------------------------------------------
# phase 7: the other model families (MoE and MLA LMs, recsys, GraphCast)
# ---------------------------------------------------------------------------

FAMILY_SEED = 24
FAMILY_GATES = {
    # (a) the two impls run the same MLA code: equal bits
    "deepseek_cpu_hidden_err": 2e-3, "deepseek_cpu_loss": 1e-4,
    # teacher-forced decode against the no-cache forward, f32 compute
    "decode_logits": 1e-3,
    # (b) arctic's logits, flash vs the chunked path.  A token whose two
    # router probabilities nearly tie (their gap below the impls' rounding
    # difference) may pick another expert, and moves the capacity drops of
    # its experts' later tokens: at bf16 that is a few percent of the rows,
    # so the gates hold the median row and most rows; at f32 (differences
    # near 1e-6) the median and all but 0.5% of the rows, tightly
    "arctic_cos": {"bf16": {"median": 0.999, "row": 0.99, "share": 0.9},
                   "f32": {"median": 0.99999, "row": 0.9999,
                           "share": 0.995}},
    # (c), (d): the card against the CPU at f32, relative to the scale
    "recsys_rel": 1e-4, "graphcast_err": 1e-3, "graphcast_loss_rel": 1e-4,
}
# the serve_batch shape of the LM phase: batch 4, prompt 128, gen 16
FAMILY_SERVE = {"batch": 4, "prompt": 128, "gen": 16}
ARCTIC_LAYERS = 2
# minibatch_lg: reddit's 232,965 nodes and 602 features, its edges cut to
# this many random out-neighbours a node (reddit has ~492), which the host
# sorts into a CSR in about a second
MINIBATCH_DEGREE = 32
# the minibatch's CPU comparison runs the card's processor cut to this depth
MINIBATCH_CPU_LAYERS = 2


def to_cpu(tree):
    if isinstance(tree, dict):
        return {key: to_cpu(val) for key, val in tree.items()}
    return tree.cpu()


def n_elements(tree) -> int:
    from repro_torch.ckpt import checkpoint as ckpt
    return sum(t.numel() for _, t in ckpt.flatten(tree))


def n_bytes(tree) -> int:
    from repro_torch.ckpt import checkpoint as ckpt
    return sum(t.numel() * t.element_size() for _, t in ckpt.flatten(tree))


def timed_serve(params, cfg, prompts, gen, calls: int = 3):
    """serve_batch: one warm-up call, then ``calls`` timed ones (host clock
    to a synchronize); launches counted over the timed calls."""
    from repro_torch.launch import lm_demo
    lm_demo.serve_batch(params, cfg, prompts, gen)
    reset_all_launches()
    seconds = []
    for _ in range(calls):
        out, s = timed(lambda: lm_demo.serve_batch(params, cfg, prompts,
                                                   gen))
        seconds.append(s)
    launches = all_launches()
    B = prompts.shape[0]
    return out, launches, {"seconds": seconds,
                           "tokens_per_s": B * gen / statistics.median(
                               seconds)}


def teacher_forced_err(params, cfg, seq, P):
    """Prefill ``seq[:, :P]``, then decode ``seq[:, P:]`` one token a step;
    the largest |step logits - the no-cache forward's logits at that
    position| over the steps, and the steps' launches."""
    from repro_torch.models import transformer as tfm
    S = seq.shape[1]
    with torch.inference_mode():
        full = tfm.logits(params, cfg, tfm.forward(params, cfg, seq)[0])
        _, caches = tfm.prefill(params, cfg, seq[:, :P], max_len=S)
        reset_all_launches()
        err = 0.0
        for i in range(P, S):
            step, _ = tfm.decode_step(params, cfg, caches, seq[:, i:i + 1],
                                      i)
            err = max(err, float((step[:, 0] - full[:, i]).abs().max()))
        launches = all_launches()
    return err, launches


def lm_impls_part(name, params, full, tokens, per_forward):
    """``lm_loss`` and ``forward`` under ``attn_impl`` "cuda" and "torch":
    each first call checked and counted (``per_forward`` flash launches a
    forward under "cuda"), then five timed by CUDA events."""
    import dataclasses

    from repro_torch.models import transformer as tfm
    out = {}
    dt = "bf16" if full.compute_dtype == torch.bfloat16 else "f32"
    for impl in ("cuda", "torch"):
        cfg = dataclasses.replace(full, attn_impl=impl)
        with torch.inference_mode():
            reset_all_launches()
            loss, metrics = tfm.lm_loss(params, cfg, {"tokens": tokens})
            loss_launches = all_launches()
            reset_all_launches()
            hidden, _, aux = tfm.forward(params, cfg, tokens)
            fwd_launches = all_launches()
            loss_ms = call_times_ms(
                lambda: tfm.lm_loss(params, cfg, {"tokens": tokens}))
            fwd_ms = call_times_ms(lambda: tfm.forward(params, cfg, tokens))
            lg = tfm.logits(params, cfg, hidden)
        want = {key: 0 for key in loss_launches}
        if impl == "cuda":
            want[f"flash_attention_{dt}"] = per_forward
        check(loss_launches == want and fwd_launches == want,
              f"{name} {impl}: launches {loss_launches} (lm_loss), "
              f"{fwd_launches} (forward), expected {want}")
        check(hidden.shape == (*tokens.shape, full.d_model)
              and bool(torch.isfinite(lg).all())
              and math.isfinite(float(loss)) and float(metrics["aux"]) > 0,
              f"{name} {impl}: non-finite logits or loss, or no aux")
        check(torch.equal(loss, metrics["xent"]
                          + full.router_aux_coef * metrics["aux"]),
              f"{name} {impl}: lm_loss is not xent + coef * aux")
        out[impl] = {"loss": loss, "xent": float(metrics["xent"]),
                     "aux": float(metrics["aux"]), "hidden": hidden,
                     "logits": lg, "lm_loss_ms": loss_ms,
                     "forward_ms": fwd_ms, "launches": loss_launches}
    return out


def deepseek_part(device):
    """(a) deepseek-v2-lite-16b: full width and depth in bf16, then two
    layers in f32 against the CPU and its absorbed decode."""
    import dataclasses

    from repro_torch.configs import deepseek_v2_lite_16b
    from repro_torch.launch import lm_demo
    from repro_torch.models import transformer as tfm
    t0 = time.perf_counter()
    full = dataclasses.replace(deepseek_v2_lite_16b.full_config(),
                               param_dtype=torch.bfloat16)
    params = device_params(full, FAMILY_SEED, device)
    emit({"phase": "families", "part": "a", "setup": "params",
          "config": full.name, "layers": full.n_layers,
          "n_params": n_elements(params), "gb": n_bytes(params) / 1e9,
          "seconds": time.perf_counter() - t0})
    rng = np.random.default_rng(FAMILY_SEED)
    B, S = 4, 2048
    tokens = torch.from_numpy(rng.integers(1, full.vocab_size, (B, S))
                              .astype(np.int32)).to(device)
    torch.cuda.reset_peak_memory_stats()
    out = lm_impls_part("deepseek", params, full, tokens, 0)
    a, b = out["cuda"], out["torch"]
    # MLA takes the chunked path under either impl: the same code, bits
    check(torch.equal(a["hidden"], b["hidden"]) and torch.equal(
        a["loss"], b["loss"]), "deepseek: the two impls differ")
    emit({"phase": "families", "part": "a", "config": full.name,
          "compute_dtype": "bf16", "B": B, "S": S,
          "loss": float(a["loss"]), "xent": a["xent"], "aux": a["aux"],
          "impls_equal": True,
          "ms": {impl: {"lm_loss": out[impl]["lm_loss_ms"],
                        "forward": out[impl]["forward_ms"]} for impl in out},
          "launches": {impl: out[impl]["launches"] for impl in out},
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    del out, a, b
    P, G = FAMILY_SERVE["prompt"], FAMILY_SERVE["gen"]
    prompts = tokens[:FAMILY_SERVE["batch"], :P].contiguous()
    serve, gens = {}, {}
    for impl in ("cuda", "torch"):
        cfg = dataclasses.replace(full, attn_impl=impl)
        gens[impl], launches, serve[impl] = timed_serve(params, cfg, prompts,
                                                        G)
        check(not any(launches.values()), f"deepseek serve_batch {impl}: "
              f"launches {launches}, expected none")
        check(gens[impl].shape == (prompts.shape[0], G)
              and bool(((gens[impl] >= 0)
                        & (gens[impl] < full.vocab_size)).all()),
              f"deepseek serve_batch {impl}: {tuple(gens[impl].shape)}")
    check(torch.equal(gens["cuda"], gens["torch"]),
          "deepseek serve_batch tokens differ between impls")
    trace = traced("deepseek_serve_batch", lambda: lm_demo.serve_batch(
        params, dataclasses.replace(full, attn_impl="cuda"), prompts, G),
        ())
    emit({"phase": "families", "part": "a", "config": full.name,
          "serve_batch": FAMILY_SERVE, "serve": serve,
          "tokens_equal": True, "sample": gens["cuda"][0].tolist(),
          "device_idle_share": trace["idle_share_of_wall"],
          "trace_top": trace["top"][:6]})
    del params, tokens, prompts
    torch.cuda.empty_cache()

    # two layers (one dense, one MoE) at full width, f32: card vs CPU, and
    # the absorbed decode against the no-cache forward with no drops
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(full, n_layers=2, param_dtype=torch.float32,
                               compute_dtype=torch.float32)
    params2 = device_params(cfg2, FAMILY_SEED + 1, device)
    cpu_params = to_cpu(params2)
    toks = torch.from_numpy(rng.integers(1, full.vocab_size, (2, 256))
                            .astype(np.int32))
    with torch.inference_mode():
        cpu_h = tfm.forward(cpu_params, cfg2, toks)[0]
        cpu_loss = float(tfm.lm_loss(cpu_params, cfg2, {"tokens": toks})[0])
        gpu_h = tfm.forward(params2, cfg2, toks.to(device))[0].cpu()
        gpu_loss = float(tfm.lm_loss(params2, cfg2,
                                     {"tokens": toks.to(device)})[0])
    err = float((gpu_h - cpu_h).abs().max())
    check(err <= FAMILY_GATES["deepseek_cpu_hidden_err"]
          and abs(gpu_loss - cpu_loss) <= FAMILY_GATES["deepseek_cpu_loss"],
          f"deepseek card vs CPU: hidden {err:.3g}, loss {gpu_loss} vs "
          f"{cpu_loss}")
    del cpu_params
    cfgE = dataclasses.replace(cfg2, moe_capacity_factor=float(
        cfg2.moe_num_experts))
    seq = torch.from_numpy(rng.integers(1, full.vocab_size, (2, P + G))
                           .astype(np.int32)).to(device)
    dec_err, dec_launches = teacher_forced_err(params2, cfgE, seq, P)
    check(dec_err <= FAMILY_GATES["decode_logits"] and not any(
        dec_launches.values()), f"deepseek absorbed decode: logits "
          f"{dec_err:.3g} from the no-cache forward, launches {dec_launches}")
    emit({"phase": "families", "part": "a", "config": cfg2.name,
          "layers": 2, "compute_dtype": "f32", "S": 256,
          "cpu_hidden_max_abs_err": err,
          "cpu_gate": FAMILY_GATES["deepseek_cpu_hidden_err"],
          "loss_card": gpu_loss, "loss_cpu": cpu_loss,
          "capacity_factor": cfgE.moe_capacity_factor,
          "decode_vs_forward_logits_max_abs_err": dec_err,
          "decode_gate": FAMILY_GATES["decode_logits"],
          "seconds": time.perf_counter() - t0})
    del params2
    torch.cuda.empty_cache()


def arctic_part(device):
    """(b) arctic-480b at full width, 2 of its 35 layers, bf16: flash in
    forward / lm_loss, decode in serve_batch, and the teacher-forced decode
    at f32 compute.  Returns the launches of the kernels line."""
    import dataclasses

    from repro_torch.configs import arctic_480b
    from repro_torch.models import transformer as tfm
    t0 = time.perf_counter()
    published = arctic_480b.full_config()
    full = dataclasses.replace(published, n_layers=ARCTIC_LAYERS,
                               param_dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    params = device_params(full, FAMILY_SEED + 2, device)
    per_layer = n_bytes({"l": params["moe_layers"]}) / ARCTIC_LAYERS
    emit({"phase": "families", "part": "b", "setup": "params",
          "config": full.name, "layers": ARCTIC_LAYERS,
          "of_layers": published.n_layers, "n_params": n_elements(params),
          "gb": n_bytes(params) / 1e9,
          "full_depth_gb": (n_bytes(params) + per_layer
                            * (published.n_layers - ARCTIC_LAYERS)) / 1e9,
          "seconds": time.perf_counter() - t0})
    rng = np.random.default_rng(FAMILY_SEED + 2)
    tokens = torch.from_numpy(rng.integers(1, full.vocab_size, (1, 2048))
                              .astype(np.int32)).to(device)
    measured = {}
    for dt in ("bf16", "f32"):
        cfg = dataclasses.replace(full, compute_dtype=TORCH_DT[dt])
        out = lm_impls_part(f"arctic {dt}", params, cfg, tokens,
                            ARCTIC_LAYERS)
        measured[f"flash_{dt}"] = \
            out["cuda"]["launches"][f"flash_attention_{dt}"]
        cos = row_cosines(out["cuda"]["logits"], out["torch"]["logits"])
        gate = FAMILY_GATES["arctic_cos"][dt]
        median = float(cos.median())
        share = float((cos >= gate["row"]).float().mean())
        check(median >= gate["median"] and share >= gate["share"],
              f"arctic {dt} logits cuda vs torch: median row cosine "
              f"{median}, {share:.4f} of rows >= {gate['row']}")
        row = {"phase": "families", "part": "b", "config": full.name,
               "compute_dtype": dt, "B": 1, "S": 2048,
               "heads": {"H": full.n_heads, "KV": full.n_kv_heads,
                         "G": full.n_heads // full.n_kv_heads,
                         "d": full.head_dim},
               "capacity": tfm.moe_capacity(full, 2048),
               "loss": {impl: float(out[impl]["loss"]) for impl in out},
               "aux": out["cuda"]["aux"],
               "logits_median_row_cos": median,
               "logits_min_row_cos": float(cos.min()),
               "rows_at_gate_share": share, "gate": gate,
               "ms": {impl: {"lm_loss": out[impl]["lm_loss_ms"],
                             "forward": out[impl]["forward_ms"]}
                      for impl in out},
               "launches": {impl: out[impl]["launches"] for impl in out}}
        del out
        if dt == "bf16":
            trace = traced("arctic_forward", lambda: tfm.forward(
                params, dataclasses.replace(cfg, attn_impl="cuda"), tokens),
                ("flash_fwd",))
            row.update(device_idle_share=trace["idle_share_of_wall"],
                       flash_ms=trace["kernels_ms"],
                       trace_top=trace["top"][:6])
        emit(row)
    P, G = FAMILY_SERVE["prompt"], FAMILY_SERVE["gen"]
    B = FAMILY_SERVE["batch"]
    prompts = torch.from_numpy(rng.integers(1, full.vocab_size, (B, P))
                               .astype(np.int32)).to(device)
    serve = {}
    for impl in ("cuda", "torch"):
        cfg = dataclasses.replace(full, attn_impl=impl)
        gen, launches, serve[impl] = timed_serve(params, cfg, prompts, G)
        want = {key: 0 for key in launches}
        if impl == "cuda":
            want["decode_attention_bf16"] = 3 * ARCTIC_LAYERS * (G - 1)
            measured["decode_bf16"] = launches["decode_attention_bf16"]
        check(launches == want, f"arctic serve_batch {impl}: launches "
              f"{launches}, expected {want}")
        check(gen.shape == (B, G), f"arctic serve_batch {impl}: "
              f"{tuple(gen.shape)}")
    emit({"phase": "families", "part": "b", "config": full.name,
          "serve_batch": FAMILY_SERVE, "serve": serve,
          "capacity_prefill": tfm.moe_capacity(full, P),
          "decode_launches_per_step": ARCTIC_LAYERS})
    # f32 compute, no drops: the decode kernel's steps against the flash
    # forward (the bf16 experts are cast to f32 a block at a time)
    cfg32 = dataclasses.replace(full, compute_dtype=torch.float32,
                                attn_impl="cuda", moe_capacity_factor=float(
                                    full.moe_num_experts))
    seq = torch.from_numpy(rng.integers(1, full.vocab_size, (2, P + G))
                           .astype(np.int32)).to(device)
    err, launches = teacher_forced_err(params, cfg32, seq, P)
    check(launches["decode_attention_f32"] == ARCTIC_LAYERS * G
          and err <= FAMILY_GATES["decode_logits"],
          f"arctic f32 decode vs flash forward: logits {err:.3g}, "
          f"launches {launches}")
    measured["decode_f32"] = launches["decode_attention_f32"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "families", "part": "b", "config": full.name,
          "compute_dtype": "f32", "capacity_factor":
          cfg32.moe_capacity_factor, "P": P, "G": G,
          "decode_vs_flash_logits_max_abs_err": err,
          "gate": FAMILY_GATES["decode_logits"],
          "decode_f32_launches": measured["decode_f32"], "peak_gb": peak})
    del params
    torch.cuda.empty_cache()
    return measured


def recsys_batch(cfg, rng, B):
    from repro_torch.data import synthetic
    if cfg.model_type == "sasrec":
        return synthetic.sasrec_batch(rng, cfg.item_vocab, B, cfg.seq_len,
                                      cfg.n_negatives)
    if cfg.model_type == "bert4rec":
        return synthetic.bert4rec_batch(rng, cfg.item_vocab, B, cfg.seq_len,
                                        cfg.seq_len // 10, cfg.n_negatives)
    if cfg.model_type == "mind":
        return synthetic.mind_batch(rng, cfg.item_vocab, B, cfg.seq_len,
                                    cfg.n_negatives)
    return synthetic.deepfm_batch(rng, cfg.field_vocab_sizes, B, cfg.max_hot)


def rel_err(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / max(1.0, float(
        want.abs().max()))


def recsys_part(device):
    """(c) bert4rec, sasrec, mind and deepfm at their full configs, f32:
    serve_fn at serve_p99, retrieval at retrieval_cand, loss_fn at batch
    512, each against the CPU."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.core.retrieval import topk_exact
    from repro_torch.models import recsys as rcs
    shapes = registry.RECSYS_SHAPES
    B = shapes["serve_p99"]["batch"]
    n_cand = shapes["retrieval_cand"]["n_candidates"]
    gate = FAMILY_GATES["recsys_rel"]
    for i, arch in enumerate(("bert4rec", "sasrec", "mind", "deepfm")):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(registry.get(arch).full_config(),
                                  compute_dtype=torch.float32)
        params = device_params(cfg, FAMILY_SEED + 10 + i, device, rcs)
        cpu = to_cpu(params)
        rng = np.random.default_rng(FAMILY_SEED + 10 + i)
        row = {"phase": "families", "part": "c", "config": cfg.name,
               "n_params": n_elements(params), "gb": n_bytes(params) / 1e9}
        # serve_fn: 512 requests, a slate of 1000 candidates
        batch = recsys_batch(cfg, rng, B)
        if arch == "deepfm":
            sb = {"ids": batch["ids"], "valid": batch["valid"]}
        else:
            sb = {"hist": batch.get("hist", batch.get("tokens")),
                  "cand_ids": rng.integers(1, cfg.item_vocab,
                                           cfg.n_serve_candidates)
                  .astype(np.int32)}
        tb = {k: torch.from_numpy(v) for k, v in sb.items()}
        gb = {k: v.to(device) for k, v in tb.items()}
        with torch.inference_mode():
            got = rcs.serve_fn(params, cfg, gb)
            want = rcs.serve_fn(cpu, cfg, tb)
            row["serve_ms"] = call_times_ms(
                lambda: rcs.serve_fn(params, cfg, gb))
        row["serve_shape"] = list(got.shape)
        row["serve_rel_err"] = rel_err(got, want)
        check(bool(torch.isfinite(got).all()) and row["serve_rel_err"]
              <= gate, f"{arch} serve_fn card vs CPU: {row['serve_rel_err']}")
        # loss_fn, forward only, batch 512
        lb = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.inference_mode():
            gl = float(rcs.loss_fn(params, cfg, {k: v.to(device) for k, v
                                                 in lb.items()})[0])
            cl = float(rcs.loss_fn(cpu, cfg, lb)[0])
        row["loss_card"], row["loss_cpu"] = gl, cl
        check(math.isfinite(gl) and abs(gl - cl) <= gate * max(1.0, abs(cl)),
              f"{arch} loss_fn card {gl} vs CPU {cl}")
        if arch != "deepfm":
            # retrieval: one user against 10^6 candidates, exact top 100
            hist = torch.from_numpy(sb["hist"][:1])
            cand_ids = torch.arange(1, n_cand + 1, dtype=torch.int32)

            def retrieve(p, h, ids):
                u = rcs.user_embed(p, cfg, h)
                if u.dim() == 3:            # mind: its K interests
                    u = u.reshape(-1, u.shape[-1])
                cand = rcs._item_table(p, cfg).float()[ids.long()]
                return topk_exact(u.float(), cand, k=100, block=65536)

            with torch.inference_mode():
                gs, gi = retrieve(params, hist.to(device),
                                  cand_ids.to(device))
                cs, ci = retrieve(cpu, hist, cand_ids)
                row["retrieval_ms"] = call_times_ms(lambda: retrieve(
                    params, hist.to(device), cand_ids.to(device)))
            row["retrieval_ids_equal"] = bool(torch.equal(gi.cpu(), ci))
            row["retrieval_score_err"] = float((gs.cpu() - cs).abs().max())
            check(row["retrieval_ids_equal"]
                  and row["retrieval_score_err"] <= 1e-5,
                  f"{arch} retrieval: ids equal {row['retrieval_ids_equal']},"
                  f" scores {row['retrieval_score_err']}")
        row["seconds"] = time.perf_counter() - t0
        emit(row)
        del params, cpu
        torch.cuda.empty_cache()


def graphcast_part(device):
    """(d) graphcast at its full config (16 layers, d_hidden 512, 227
    variables) on full_graph_sm and on one minibatch_lg subgraph, f32,
    against the CPU; then at the config's bf16 on the card."""
    import dataclasses

    from repro_torch.configs import graphcast, registry
    from repro_torch.data import sampler, synthetic
    from repro_torch.models import graphcast as gc
    shapes = registry.GNN_SHAPES
    base = dataclasses.replace(graphcast.full_config(),
                               compute_dtype=torch.float32)
    rng = np.random.default_rng(FAMILY_SEED + 20)

    def run(name, cfg, batch, cpu_layers):
        t0 = time.perf_counter()
        params = device_params(cfg, FAMILY_SEED + 21, device, gc)
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        gb = {k: v.to(device) for k, v in tb.items()}
        args = ("node_feat", "src", "dst")
        with torch.inference_mode():
            pred = gc.forward(params, cfg, *(gb[k] for k in args))
            loss = float(gc.loss_fn(params, cfg, gb)[0])
            ms = {"forward": call_times_ms(lambda: gc.forward(
                params, cfg, *(gb[k] for k in args)))}
            bcfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
            bf16_pred = gc.forward(params, bcfg, *(gb[k] for k in args))
            ms["forward_bf16"] = call_times_ms(lambda: gc.forward(
                params, bcfg, *(gb[k] for k in args)))
            # the CPU at cpu_layers of the processor (the card's too)
            cut = dataclasses.replace(cfg, n_layers=cpu_layers)
            sub = dict(params, processor=_head_layers(params["processor"],
                                                      cpu_layers))
            cpu = to_cpu(sub)
            card_cut = gc.forward(sub, cut, *(gb[k] for k in args)).cpu()
            cpu_pred = gc.forward(cpu, cut, *(tb[k] for k in args))
            cpu_loss = float(gc.loss_fn(cpu, cut, tb)[0])
            card_loss = float(gc.loss_fn(sub, cut, gb)[0])
        err = float((card_cut - cpu_pred).abs().max())
        loss_rel = abs(card_loss - cpu_loss) / max(1.0, abs(cpu_loss))
        check(pred.shape == (batch["node_feat"].shape[0], cfg.n_vars)
              and bool(torch.isfinite(pred).all())
              and bool(torch.isfinite(bf16_pred).all())
              and math.isfinite(loss), f"graphcast {name}: non-finite")
        check(err <= FAMILY_GATES["graphcast_err"]
              and loss_rel <= FAMILY_GATES["graphcast_loss_rel"],
              f"graphcast {name} card vs CPU: {err:.3g}, loss {card_loss} "
              f"vs {cpu_loss}")
        emit({"phase": "families", "part": "d", "config": cfg.name,
              "shape": name, "layers": cfg.n_layers, "d_hidden":
              cfg.d_hidden, "d_feat": cfg.d_feat,
              "nodes": int(batch["node_feat"].shape[0]),
              "edges": int(batch["src"].shape[0]), "loss": loss,
              "cpu_layers": cpu_layers, "cpu_max_abs_err": err,
              "cpu_loss_rel_err": loss_rel, "bf16_vs_f32_max_abs_diff":
              float((bf16_pred - pred).abs().max()), "ms": ms,
              "seconds": time.perf_counter() - t0})
        del params, cpu, sub
        torch.cuda.empty_cache()

    sm = shapes["full_graph_sm"]
    batch = synthetic.graph_batch(rng, sm["n_nodes"], sm["n_edges"],
                                  sm["d_feat"], base.n_vars)
    run("full_graph_sm", dataclasses.replace(base, d_feat=sm["d_feat"]),
        batch, base.n_layers)
    lg = shapes["minibatch_lg"]
    t0 = time.perf_counter()
    n = lg["n_nodes"]
    n_edges = n * MINIBATCH_DEGREE
    graph = sampler.CSRGraph.from_edges(
        rng.integers(0, n, n_edges).astype(np.int32),
        rng.integers(0, n, n_edges).astype(np.int32), n)
    seeds = rng.choice(n, lg["batch_nodes"], replace=False).astype(np.int64)
    sub = sampler.sample_subgraph(graph, seeds, lg["fanout"], rng)
    d_feat = 602                                  # reddit's node features
    feats = rng.standard_normal((n, d_feat), np.float32)
    nodes = np.where(sub["nodes"] >= 0, sub["nodes"], 0)
    mb = {"node_feat": feats[nodes], "src": sub["src"], "dst": sub["dst"],
          "target": rng.standard_normal((len(nodes), base.n_vars),
                                        np.float32),
          "node_mask": sub["node_mask"]}
    emit({"phase": "families", "part": "d", "shape": "minibatch_lg",
          "setup": "graph", "nodes": n, "edges": n_edges,
          "edges_published": lg["n_edges"], "batch_nodes": lg["batch_nodes"],
          "fanout": list(lg["fanout"]),
          "subgraph_nodes": int(sub["node_mask"].sum()),
          "subgraph_edges": int(sub["edge_mask"].sum()),
          "padded": list(sampler.sampled_subgraph_shape(lg["batch_nodes"],
                                                        lg["fanout"])),
          "seconds": time.perf_counter() - t0})
    del graph, feats
    run("minibatch_lg", dataclasses.replace(base, d_feat=d_feat), mb,
        MINIBATCH_CPU_LAYERS)
    op = shapes["ogb_products"]
    emit({"phase": "families", "part": "d", "shape": "ogb_products",
          "run": False, "edge_latents_gb_bf16":
          op["n_edges"] * base.d_hidden * 2 / 1e9,
          "why": "its edge latents alone outgrow the card's 80 GB"})


def _head_layers(stack, n):
    if isinstance(stack, dict):
        return {key: _head_layers(val, n) for key, val in stack.items()}
    return stack[:n]


def families_phase(device):
    """Phase 7: (a) deepseek-v2-lite-16b, (b) arctic-480b, (c) the four
    recommenders, (d) graphcast.  Returns arctic's kernel launches."""
    t_phase = time.perf_counter()
    moe_ties_part(device)
    deepseek_part(device)
    measured = arctic_part(device)
    recsys_part(device)
    graphcast_part(device)
    emit({"phase": "families", "ok": True,
          "seconds": time.perf_counter() - t_phase})
    return measured


MOE_TIE_TOKENS = (2, 192)        # (batch, sequence) of the tie check
MOE_TIE_EXPERT_FF = 64           # expert width of the tie check


def moe_ties_part(device):
    """(e) MoE routing ties (C2) on the card: ``_moe_block`` at arctic-480b's
    routing geometry (E = 128 experts, top 2, d_model 7168; the experts cut
    to ``MOE_TIE_EXPERT_FF`` wide) on 2 x 192 tokens, at f32 and bf16
    compute, with a zero router (every probability 1/128) and with a router
    whose first 64 columns are 32 equal pairs.  Inputs and router are
    multiples of 1/4 and 1/8 below 1, so every logit is exact on either
    device and equal columns give equal probabilities.  The experts each
    token is routed to (as ``_moe_dispatch`` receives them) must equal the
    CPU's, and be [0, 1] for every token under the zero router."""
    import dataclasses
    from repro_torch.configs import arctic_480b
    from repro_torch.models import transformer as tfm
    t0 = time.perf_counter()
    full = arctic_480b.full_config()
    E, D, F = full.moe_num_experts, full.d_model, MOE_TIE_EXPERT_FF
    rng = np.random.default_rng(FAMILY_SEED)
    x = (rng.integers(-3, 4, size=MOE_TIE_TOKENS + (D,)) / 4) \
        .astype(np.float32)
    experts = {key: (0.02 * rng.standard_normal(shape)).astype(np.float32)
               for key, shape in (("w1", (E, D, F)), ("w3", (E, D, F)),
                                  ("w2", (E, F, D)))}
    dup = (rng.integers(-3, 4, size=(D, E)) / 8).astype(np.float32)
    dup[:, 1:E // 2:2] = dup[:, 0:E // 2:2]
    routers = {"zero": np.zeros((D, E), np.float32), "dup": dup}
    seen = []
    real = tfm._moe_dispatch

    def spy(xs, expert_idx, *rest):
        seen.append(expert_idx)
        return real(xs, expert_idx, *rest)

    cases = []
    tfm._moe_dispatch = spy
    try:
        for dt in ("f32", "bf16"):
            cfg = dataclasses.replace(full, moe_d_ff=F,
                                      compute_dtype=TORCH_DT[dt])
            for case, router in routers.items():
                idx, outs = {}, {}
                for where, dev in (("card", device),
                                   ("cpu", torch.device("cpu"))):
                    p = {key: torch.from_numpy(v).to(dev) for key, v in
                         dict(experts, router=router).items()}
                    seen.clear()
                    with torch.inference_mode():
                        out, _ = tfm._moe_block(
                            p, torch.from_numpy(x).to(dev, TORCH_DT[dt]),
                            cfg)
                    check(len(seen) == 1, f"moe ties: {len(seen)} "
                          "dispatches")
                    idx[where] = seen[0].cpu()
                    outs[where] = out.float().cpu()
                    del p
                probs = torch.softmax(
                    torch.from_numpy(x).to(TORCH_DT[dt]).float()
                    @ torch.from_numpy(router), dim=-1)
                top = torch.gather(probs, -1, idx["cpu"])
                tied = int((top[..., 0] == top[..., 1]).sum())
                row = {"score_dtype": dt, "router": case,
                       "tokens": int(np.prod(MOE_TIE_TOKENS)),
                       "tied_tokens": tied,
                       "expert_idx_equal": bool(torch.equal(idx["card"],
                                                            idx["cpu"])),
                       "out_max_abs_diff": float(
                           (outs["card"] - outs["cpu"]).abs().max())}
                check(row["expert_idx_equal"], f"moe ties {dt}/{case}: "
                      "the card routes otherwise than the CPU")
                if case == "zero":
                    check(bool((idx["card"] == torch.arange(2)).all())
                          and tied == row["tokens"],
                          f"moe ties {dt}/zero: not [0, 1] everywhere")
                else:
                    check(0 < tied < row["tokens"],
                          f"moe ties {dt}/dup: {tied} tied tokens")
                cases.append(row)
    finally:
        tfm._moe_dispatch = real
    emit({"phase": "families", "part": "moe_ties", "experts": E,
          "top_k": full.moe_top_k, "d_model": D, "expert_ff": F,
          "cases": cases, "seconds": time.perf_counter() - t0})


def device_params(cfg, seed: int, device, model=None):
    """Random parameters made on the card from a seed with the scheme of
    ``model.init_numpy`` (``model`` defaults to the transformer): norm
    scales 1, biases 0, every other leaf N(0, ``model.init_std``), each at
    its dtype in ``model.param_dtypes`` (an MoE router in f32).  Each
    leaf is drawn in place a matrix of its trailing two axes at a time, so
    no f32 copy of a bf16 leaf is ever made: arctic's stacked experts are
    8.9 G elements a weight.  The 55 GB of a 2-layer arctic are made in
    seconds instead of minutes of host sampling and upload."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.models import nn
    from repro_torch.models import transformer as tfm
    model = model or tfm
    gen = torch.Generator(device=device).manual_seed(seed)
    dtypes = dict(ckpt.flatten(model.param_dtypes(cfg)))

    def build(node, path, name):
        if isinstance(node, dict):
            return {key: build(node[key], f"{path}/{key}" if path else key,
                               key) for key in sorted(node)}
        dt = dtypes[path]
        if name == "scale":
            return torch.ones(node, dtype=dt, device=device)
        if name in nn.ZERO_LEAVES:
            return torch.zeros(node, dtype=dt, device=device)
        t = torch.empty(node, dtype=dt, device=device)
        std = float(model.init_std(name, node))
        for mat in (t.view(-1, *node[-2:]) if len(node) > 2 else [t]):
            mat.normal_(0.0, std, generator=gen)
        return t

    return build(model.param_shapes(cfg), "", "")


def decode_step_part(part, device, params, full, shape, trace=False):
    """One bf16 ``decode_step`` at index T - 1 of a cache of capacity T
    filled with seeded random K/V at the per-(layer, head, dim) mean and
    spread of a short real prefill's, for ``attn_impl`` "cuda" (decode
    kernel) and "torch" (chunked path): first step checked and counted,
    five warm steps timed (CUDA events), logits compared by row cosine."""
    import dataclasses

    from repro_torch.models import transformer as tfm
    B, T = shape["batch"], shape["cache"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(full, compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(17)
    prompt = torch.from_numpy(rng.integers(1, full.vocab_size, (4, 64))
                              .astype(np.int32)).to(device)
    with torch.inference_mode():
        _, real = tfm.prefill(params, cfg, prompt)
    caches = tfm.init_cache(cfg, B, T, dtype=torch.bfloat16, device=device)
    gen = torch.Generator(device=device).manual_seed(18)
    for key in ("k", "v"):
        for i in range(full.n_layers):
            ref = real["dense"][key][i].float()          # (4, 64, KV, d)
            mean, std = ref.mean(dim=(0, 1)), ref.std(dim=(0, 1))
            layer = caches["dense"][key][i]
            for b0 in range(0, B, 8):                    # bf16 rows
                rows = torch.randn(layer[b0:b0 + 8].shape, generator=gen,
                                   device=device)
                layer[b0:b0 + 8] = (rows * std + mean).to(torch.bfloat16)
    del real, rows
    token = torch.from_numpy(rng.integers(1, full.vocab_size, (B, 1))
                             .astype(np.int32)).to(device)
    cache_gb = sum(t.numel() * t.element_size()
                   for t in caches["dense"].values()) / 1e9
    setup_s = time.perf_counter() - t0
    out, times, peaks, counts = {}, {}, {}, {}
    for impl in ("cuda", "torch"):
        icfg = dataclasses.replace(cfg, attn_impl=impl)

        def step():
            return tfm.decode_step(params, icfg, caches, token, T - 1)[0]

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            reset_all_launches()
            out[impl] = step()
            counts[impl] = all_launches()
            times[impl] = call_times_ms(step)
        peaks[impl] = torch.cuda.max_memory_allocated() / 1e9
        want = {key: 0 for key in counts[impl]}
        if impl == "cuda":
            want["decode_attention_bf16"] = full.n_layers
        check(counts[impl] == want, f"lm {part} {impl}: launches "
              f"{counts[impl]}, expected {want}")
        check(out[impl].shape == (B, 1, full.vocab_size)
              and bool(torch.isfinite(out[impl]).all()),
              f"lm {part} {impl}: logits {tuple(out[impl].shape)} not finite")
    cos = row_cosine(out["cuda"], out["torch"])
    err = float((out["cuda"].float() - out["torch"].float()).abs().max())
    check(cos >= LM_GATES["hidden_cos"]["bf16"],
          f"lm {part}: decode logits row cosine {cos}")
    emit({"phase": "lm", "part": part, "config": full.name,
          "layers": full.n_layers, "batch": B, "cache": T,
          "index": T - 1, "cache_gb": cache_gb, "setup_s": setup_s,
          "logits_min_row_cos": cos, "logits_max_abs_diff": err,
          "gate": LM_GATES["hidden_cos"]["bf16"], "step_ms": times,
          "peak_gb": peaks, "launches": counts})
    if trace:
        icfg = dataclasses.replace(cfg, attn_impl="cuda")
        with torch.inference_mode():
            emit(traced(f"lm_decode_step_{part}",
                        lambda: tfm.decode_step(params, icfg, caches, token,
                                                T - 1),
                        ("decode_split", "decode_merge")))
    del caches, out
    torch.cuda.empty_cache()


def device_events(prof, name):
    """The kernel, memcpy and memset records of a finished profile, read
    from its Chrome trace (``build/chip_smoke/trace_<name>.json``)."""
    path = os.path.join(ROOT, "build", "chip_smoke", f"trace_{name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def busy_us(events) -> float:
    """Length of the union of the events' device intervals (us)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo = busy + hi - lo, s
        hi = max(hi, e)
    return busy + hi - lo


def device_ms(name, fn, kernels, iters: int = 20):
    """Device time per call of the kernels whose names contain one of
    ``kernels`` over ``iters`` calls of ``fn`` under ``torch.profiler``
    (after one warm call): the union of their intervals, since a kernel
    launched with programmatic dependent launch may start before the one
    it follows ends; and each kernel's own time per call, by the entry of
    ``kernels`` its name contains."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = {}
    for _ in range(5):
        # a window can come back without device records, or with some of
        # them missing: take one where every kernel seen ran in every call
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ours = [e for e in device_events(prof, name)
                if any(k in e["name"] for k in kernels)]
        counts = {k: sum(k in e["name"] for e in ours) for k in kernels}
        if ours and all(n % iters == 0 for n in counts.values()):
            by_kernel = {k: sum(e["dur"] for e in ours if k in e["name"])
                         / 1e3 / iters for k in kernels}
            return busy_us(ours) / 1e3 / iters, {
                k: v for k, v in by_kernel.items() if v}
    raise AssertionError(f"{name}: no profiler window held every call's "
                         f"records of {kernels} (last: {counts} for "
                         f"{iters} calls)")


def device_ms_many(name, fn, per_call, iters: int = 2):
    """:func:`device_ms` for a call of many launches (``per_call``: kernel
    name -> launches per call), where a profiler window of a few thousand
    kernel records came back missing a few (1620 of 1623 at 541 windows
    a call): each kernel's device time per call is its mean record times
    its launches, the union of the intervals is scaled by the expected over
    the found records, and fewer than 99% of them found fails.  Returns
    (ms, ms by kernel, {"found", "expected"})."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ours = [e for e in device_events(prof, name)
            if any(k in e["name"] for k in per_call)]
    found = {k: sum(k in e["name"] for e in ours) for k in per_call}
    want = {k: n * iters for k, n in per_call.items()}
    check(all(found[k] >= 0.99 * want[k] for k in per_call),
          f"{name}: the profiler kept {found} of {want} kernel records")
    by_kernel = {k: sum(e["dur"] for e in ours if k in e["name"])
                 / found[k] * per_call[k] / 1e3 for k in per_call}
    busy = busy_us(ours) / 1e3 / iters * sum(want.values()) \
        / sum(found.values())
    return busy, by_kernel, {"found": found, "expected": want}


def traced(name, fn, kernels):
    """Run ``fn`` once under ``torch.profiler``.  From the exported Chrome
    trace: device time by kernel, the time of the kernels whose names
    contain one of ``kernels``, and the device's busy time (union of
    kernel, memcpy and memset intervals) against the wall time of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = device_events(prof, name)
    check(bool(dev), f"the {name} trace holds no device activity")
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy = busy_us(dev)
    by_name: dict = {}
    for e in dev:
        key = e["name"][:90]
        tot, n = by_name.get(key, (0.0, 0))
        by_name[key] = (tot + e["dur"], n + 1)
    ours_us = sum(e["dur"] for e in dev
                  if any(k in e["name"] for k in kernels))
    return {"phase": "trace", "path": name, "wall_s": wall,
            "device_busy_s": busy / 1e6,
            "device_span_s": (spans[-1][1] - spans[0][0]) / 1e6,
            "idle_share_of_wall": 1 - busy / 1e6 / wall,
            "kernels": list(kernels), "kernels_ms": ours_us / 1e3,
            "top": [{"name": n, "device_ms": t / 1e3, "count": c}
                    for n, (t, c) in sorted(by_name.items(),
                                            key=lambda kv: -kv[1][0])[:12]]}


def trace_phase():
    """One ``--impl cuda --score_dtype bf16`` validation of one checkpoint,
    traced; its wall time includes the restore from disk."""
    from repro_torch.core import cli
    work = os.path.join(ROOT, "build", "chip_smoke")
    args = ["--query_file", os.path.join(work, "q.jsonl"),
            "--candidate_dir", os.path.join(work, "corpus"),
            "--ckpts_dir", os.path.join(work, "ckpts"),
            "--qrel_file", os.path.join(work, "qrels.txt"),
            "--q_max_len", "32", "--p_max_len", "128", "--impl", "cuda",
            "--score_dtype", "bf16", "--chunk_size", "1024",
            "--batch_size", "256", "--max_num_valid", "1",
            "--output_dir", os.path.join(work, "out_trace")]
    emit(traced("validate_bf16",
                lambda: check(cli.main(args) == 0, "traced cli run failed"),
                TOPK_KERNELS))


def build_kernels():
    """Build every kernel library, one nvcc per source, all started
    together; return the device phase's build record."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.topk_mips import ops as topk_ops
    t0 = time.perf_counter()
    build.load_libraries({**topk_ops.LIBRARY, **flash_ops.LIBRARY,
                          **decode_ops.LIBRARY})
    return {"build_s": time.perf_counter() - t0,
            "nvcc_s": {name: info["seconds"]
                       for name, info in build.BUILD_INFO.items()},
            "ptxas": {name: [ln for ln in info["log"].splitlines()
                             if "registers" in ln or "spill" in ln]
                      for name, info in build.BUILD_INFO.items()}}


def build_records(lib, names):
    """Each kernel of library ``lib`` whose mangled name matches one of
    ``names`` (label -> regex): its ptxas registers and spill bytes, whether
    ptxas serialised its wgmma (``wgmma_serialized``: its "Potential
    Performance Loss: wgmma.mma_async instructions are serialized" remark),
    and the count of its tensor-core instructions by mnemonic (warpgroup
    MMA: ``HGMMA``, ``IGMMA``, ...; warp MMA: ``HMMA``) in its SASS from
    ``cuobjdump -sass`` of the built library ({} per kernel when it has
    none; None without cuobjdump), and ``carried_a_fragments`` of that SASS
    (None without cuobjdump)."""
    import re

    from repro_torch.kernels import build
    info = build.BUILD_INFO[lib]

    def label(ln):
        return next((k for k, pat in names.items() if re.search(pat, ln)),
                    None)

    out, cur, serialized = {}, None, set()
    for ln in info["log"].splitlines():
        if "wgmma.mma_async instructions are serialized" in ln:
            serialized.add(label(ln))
        if "Compiling entry function" in ln:
            name = label(ln)
            cur = out.setdefault(name, {}) if name else None
        elif cur is not None and "spill stores" in ln:
            cur["spill_bytes"] = sum(int(x) for x in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", ln))
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln)[1])
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = None
    if os.path.exists(tool):
        sass = subprocess.run([tool, "-sass", info["path"]],
                              capture_output=True, text=True,
                              check=True).stdout
    for name, rec in out.items():
        rec["wgmma_serialized"] = name in serialized
        rec["gmma"] = None if sass is None else {}
        rec["carried_a_fragments"] = None
    cur, lines = None, {}
    for ln in (sass or "").splitlines():
        if "Function :" in ln:
            cur = out.get(label(ln))
            if cur is not None:
                cur_lines = lines.setdefault(label(ln), [])
        elif cur is not None:
            cur_lines.append(ln)
            m = re.search(r"\b([A-Z]GMMA|HMMA)\b", ln)
            if m:
                cur["gmma"][m[1]] = cur["gmma"].get(m[1], 0) + 1
    for name, fn_lines in lines.items():
        out[name]["carried_a_fragments"] = carried_a_fragments(fn_lines)
    return out


def carried_a_fragments(sass_lines) -> int:
    """The register-A wgmma (``HGMMA Rd, Ra, gdesc[...]``) of one kernel's
    SASS whose four A registers are written later in a loop around it and
    not earlier in that loop: each iteration after the first reads them
    overwritten.  ptxas does not keep a loop-carried A fragment live past
    its HGMMA (an f32 flash variant that loaded q_lo fragments once before
    its loop read softmax values there from the second key tile on), so
    every A fragment must be built in the iteration that reads it."""
    import re
    ins = []
    for ln in sass_lines:
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if m:
            ins.append((int(m[1], 16), m[2]))
    loops = [(int(m[1], 16), a) for a, t in ins
             for m in [re.search(r"\bBRA (?:\S+, )?0x([0-9a-f]+)", t)]
             if m and int(m[1], 16) < a]

    def writes(t):
        m = re.match(r"(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)\s+R(\d+)\b", t)
        if not m or "GMMA" in m[1]:
            return set()
        n = 4 if ".128" in m[1] else 2 if (".64" in m[1]
                                            or ".WIDE" in m[1]) else 1
        return {int(m[2]) + i for i in range(n)}

    found = 0
    for a, t in ins:
        m = re.match(r"HGMMA\S*\s+R\d+, R(\d+), gdesc", t)
        if not m:
            continue
        around = [(e - s, s, e) for s, e in loops if s <= a <= e]
        if not around:
            continue
        _, start, end = min(around)               # the innermost loop
        regs = set(range(int(m[1]), int(m[1]) + 4))
        before = any(writes(u) & regs for b, u in ins if start <= b < a)
        after = any(writes(u) & regs for b, u in ins if a < b <= end)
        found += after and not before
    return found


def flash_instantiations():
    """Each flash instantiation's ptxas registers and spill bytes, whether
    ptxas serialised its wgmma, the counts of ``HGMMA`` (wgmma) and
    ``HMMA`` (mma.sync) instructions in its SASS and its
    ``carried_a_fragments``.  Every instantiation, bf16 and f32, must run
    on tensor cores, spill nothing, keep its wgmma asynchronous and build
    each register A fragment in the iteration that reads it."""
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
    recs = build_records("flash_attention", {
        f"flash_fwd_{dt}<{d}>": rf"flash_fwd_{dt}ILi{d}E"
        for dt in ("bf16", "f32") for d in HEAD_DIMS})
    for rec in recs.values():
        gmma = rec.pop("gmma")
        rec["hgmma"] = None if gmma is None else gmma.get("HGMMA", 0)
        rec["hmma"] = None if gmma is None else gmma.get("HMMA", 0)
    for dt in ("bf16", "f32"):
        for d in HEAD_DIMS:
            name = f"flash_fwd_{dt}<{d}>"
            rec = recs.get(name, {})
            check(rec.get("spill_bytes") == 0, f"{name}: ptxas reports {rec}")
            check(not rec.get("wgmma_serialized"),
                  f"{name}: ptxas serialised its wgmma")
            check(rec.get("hgmma") is None
                  or rec["hgmma"] + rec["hmma"] != 0,
                  f"{name} has no HGMMA or HMMA in its SASS")
            check(not rec.get("carried_a_fragments"),
                  f"{name}: {rec.get('carried_a_fragments')} wgmma read A "
                  f"fragments that a later instruction of their loop "
                  f"overwrites")
    return {"phase": "flash_build", "instantiations": recs}


# topk_mips kernels by label: the mangled-name pattern of each
TOPK_BUILD = {"score_f32": r"score_f32", "score_tc<bf16>": r"score_tcIfE",
              "score_tc<int8>": r"score_tcIiE", "select_topk": r"select_topk"}
# names in the profiler's kernel records
TOPK_KERNELS = ("score_f32", "score_tc", "select_topk")


def topk_instantiations():
    """The topk_mips kernels' ptxas registers and spill bytes and their
    warpgroup MMA counts.  No kernel may spill; the bf16 and int8 scoring
    kernels must run on tensor cores."""
    recs = build_records("topk_mips", TOPK_BUILD)
    for name in TOPK_BUILD:
        rec = recs.get(name, {})
        check(rec.get("spill_bytes") == 0, f"{name}: ptxas reports {rec}")
    for name in ("score_tc<bf16>", "score_tc<int8>"):
        gmma = recs[name]["gmma"]
        check(gmma is None or sum(gmma.values()) > 0,
              f"{name} has no warpgroup MMA in its SASS")
    return {"phase": "topk_build", "kernels": recs}


# decode kernels by label: bf16 has one pass-1 instantiation per head dim,
# f32 one per head dim and padded group GT
DECODE_BUILD = {
    **{f"decode_split_tc<{d}>": rf"decode_split_tcILi{d}EE"
       for d in (8, 16, 32, 64, 128)},
    **{f"decode_split_f32<{d},{gt}>": rf"decode_split_f32ILi{d}ELi{gt}EE"
       for d in (8, 16, 32, 64, 128) for gt in (1, 2, 4, 8, 16)},
    "decode_merge<bf16>": r"decode_mergeI13__nv_bfloat16",
    "decode_merge<f32>": r"decode_mergeIfE"}


def decode_instantiations():
    """Each decode instantiation's ptxas registers and spill bytes and its
    count of ``HMMA`` (``mma.sync``) instructions.  Every bf16 pass-1
    instantiation at d >= 16 must run on tensor cores and spill nothing."""
    from repro_torch.kernels.decode_attention.ops import HEAD_DIMS
    recs = build_records("decode_attention", DECODE_BUILD)
    for rec in recs.values():
        gmma = rec.pop("gmma")
        rec["hmma"] = None if gmma is None else gmma.get("HMMA", 0)
    for d in HEAD_DIMS:
        name = f"decode_split_tc<{d}>"
        rec = recs.get(name, {})
        check("registers" in rec, f"{name}: no ptxas record")
        if d >= 16:
            check(rec.get("spill_bytes") == 0, f"{name}: ptxas reports "
                  f"{rec}")
            check(rec.get("hmma", 1) != 0, f"{name} has no HMMA in its SASS")
    return {"phase": "decode_build", "instantiations": recs}


def kernel_row(name, source, replaces, launches, row):
    out = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           "max_abs_err": row["max_abs_err"], "ms": row["ms"],
           "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
           "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
    for key in ("device_ms", "windows", "wrapper_ms"):
        if key in row:
            out[key] = row[key]
    return out


# ---------------------------------------------------------------------------
# Phase 8: the launch steps (dry run of every cell; the paper's three cells)
# ---------------------------------------------------------------------------

PAPER_CELLS = ("train_contrastive", "encode_corpus", "retrieve")
LAUNCH_WARMUP = 3
LAUNCH_GATE_ROWS = 64


def launch_dryrun_start():
    """(a), started: ``python -m repro_torch.launch.dryrun --all
    --skip-multipod --device cuda`` in a session of its own, its output to
    a file (one process per cell, up to 8 at a time).  Each of the cells
    of ``steps.all_cells()`` is built on the 16 x 16 production mesh and
    run on meta tensors: host work only, so it runs while part (b) times
    the paper's cells on the card."""
    out = os.path.join(WORK, "dryrun")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(WORK, exist_ok=True)
    log = open(os.path.join(WORK, "dryrun.log"), "w")
    jobs = max(1, min(8, os.cpu_count() or 1))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--skip-multipod", "--device", "cuda", "--jobs", str(jobs),
         "--out", out], stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    return {"proc": proc, "log": log, "out": out, "jobs": jobs,
            "t0": time.perf_counter()}


def launch_dryrun_stop(run) -> None:
    """Stops the dry run's process group if it still runs."""
    proc = run["proc"]
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    run["log"].close()


def launch_dryrun_finish(run):
    """(a), read: waits for the dry run, then every record must be ``ok``
    and there must be one per cell."""
    from repro_torch.launch.steps import all_cells
    try:
        rc = run["proc"].wait(timeout=900)
    finally:
        launch_dryrun_stop(run)
    seconds = time.perf_counter() - run["t0"]
    out = run["out"]
    recs = []
    for name in sorted(os.listdir(out)) if os.path.isdir(out) else []:
        with open(os.path.join(out, name)) as f:
            recs.append(json.load(f))
    ok = [r for r in recs if r.get("ok")]
    emit({"phase": "launch", "part": "a", "cells": len(recs),
          "ok_cells": len(ok), "expected": len(all_cells()),
          "seconds": seconds, "jobs": run["jobs"], "exit": rc,
          "nvidia_smi": nvidia_smi(),
          "hardware": ok[0]["hardware"] if ok else None,
          # per cell: bottleneck, roofline step_time_s, GiB a device, the
          # seconds of the full variant's meta run
          "cells_roofline": {
              f"{r['arch']}/{r['shape']}": [
                  r["roofline"]["bottleneck"], r["roofline"]["step_time_s"],
                  r["memory"]["per_device_total"] / 2**30,
                  r["timings"]["full_single_s"]] for r in ok}})
    failed = [f"{r['arch']}/{r['shape']}: {r.get('error')}" for r in recs
              if not r.get("ok")]
    with open(os.path.join(WORK, "dryrun.log")) as f:
        tail = f.read()[-3000:]
    check(rc == 0 and len(ok) == len(recs) == len(all_cells()),
          f"dry run: {len(ok)} ok of {len(recs)} records, "
          f"{len(all_cells())} cells; failed {failed}; tail {tail}")


def launch_args(spec, device, seed: int):
    """``spec.abstract_args`` made real on the card: parameters drawn on
    the card from ``seed`` with the reference's scheme
    (:func:`device_params`), optimizer state as its init makes it (zeros),
    token batches from a numpy generator (ids in [1, vocab), each row valid
    for a random length of at least 8 and 0 past it), query and corpus
    rows unit vectors drawn on the card from ``seed`` (the corpus as in
    serve phase d)."""
    from repro_torch.configs import registry
    from repro_torch.core import pytree
    cfg = registry.get("dr-bert-base").full_config()
    rng = np.random.default_rng(seed)

    def tokens_and_mask(shape):
        lengths = rng.integers(8, shape[-1] + 1, size=shape[:-1])
        mask = np.arange(shape[-1]) < lengths[..., None]
        ids = rng.integers(1, cfg.vocab_size, size=shape) * mask
        return (torch.from_numpy(ids.astype(np.int32)).to(device),
                torch.from_numpy(mask).to(device))

    def unit_rows(shape, gen_seed):
        gen = torch.Generator(device=device).manual_seed(gen_seed)
        x = torch.randn(tuple(shape), generator=gen, device=device)
        return x.div_(x.norm(dim=1, keepdim=True))

    def like(real, abstract):
        got = [(tuple(t.shape), t.dtype) for t in pytree.tree_leaves(real)]
        want = [(tuple(t.shape), t.dtype)
                for t in pytree.tree_leaves(abstract)]
        check(got == want, f"{spec.cell}: materialised args differ from "
              "the abstract ones")
        return real

    if spec.kind == "retrieval":
        q_abs, c_abs = spec.abstract_args
        return unit_rows(q_abs.shape, seed), unit_rows(c_abs.shape, seed + 1)
    params = like(device_params(cfg, seed, device), spec.abstract_args[0])
    if spec.kind == "encode":
        return (params,) + tokens_and_mask(tuple(spec.abstract_args[1].shape))
    opt = pytree.tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                                device=device),
                          spec.abstract_args[1])
    batch = {}
    for side in ("q", "p"):
        batch[f"{side}_tokens"], batch[f"{side}_mask"] = tokens_and_mask(
            tuple(spec.abstract_args[2][f"{side}_tokens"].shape))
    return like(params, spec.abstract_args[0]), \
        like(opt, spec.abstract_args[1]), like(batch, spec.abstract_args[2])


def launch_gate(shape_name, spec, args, out):
    """The cell's check of something other than the step, as a callable
    that returns the gate's record (and raises if it fails): encode_corpus
    rows against the port on the CPU (row cosine >= 0.999; both compute in
    bf16 and round differently), deferred (the card's rows and the inputs
    are copied to the host now, the CPU encode runs when called);
    retrieve's top-k ids of the first queries against ``torch.topk`` of
    the same products block by block (ties to the lower id, as the step's
    stable merge); train's loss against a separate ``contrastive_loss``
    (1e-5 relative), every updated leaf finite and changed."""
    from repro_torch.configs import registry
    from repro_torch.core import pytree
    n = LAUNCH_GATE_ROWS
    if shape_name == "encode_corpus":
        params, toks, mask = args
        host = (to_cpu(params), toks[:n].cpu(), mask[:n].cpu(),
                out[:n].cpu())

        def encode_gate():
            t0 = time.perf_counter()
            with torch.inference_mode():
                want = spec.fn(*host[:3])
            cos = row_cosines(host[3], want)
            gate = {"rows": n, "min_row_cosine": float(cos.min()),
                    "median_row_cosine": float(cos.median()),
                    "cpu_s": time.perf_counter() - t0}
            check(gate["min_row_cosine"] >= 0.999,
                  f"encode_corpus vs the CPU: {gate}")
            return gate

        return encode_gate
    if shape_name == "retrieve":
        q, c = args
        scores, ids = out
        k = registry.get("dr-bert-base").shapes["retrieve"]["k"]
        block = 65536
        cand_s, cand_i = [], []
        with torch.inference_mode():
            for b0 in range(0, c.shape[0], block):
                # the step's product shape (all queries), so its bits
                s = (q @ c[b0:b0 + block].T)[:n]
                v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
                cand_s.append(v)
                cand_i.append(i + b0)
            cs, ci = torch.cat(cand_s, 1), torch.cat(cand_i, 1)
            by_id = torch.argsort(ci, dim=1)
            cs, ci = cs.gather(1, by_id), ci.gather(1, by_id)
            order = torch.sort(cs, dim=1, descending=True,
                               stable=True).indices[:, :k]
            want = ci.gather(1, order)
        gate = {"queries": n, "k": k,
                "ids_equal": bool(torch.equal(ids[:n].long(), want)),
                "max_score_diff": float((scores[:n] - cs.gather(1, order))
                                        .abs().max())}
        check(gate["ids_equal"], f"retrieve vs torch.topk: {gate}")
        return lambda: gate
    from repro_torch.models.biencoder import biencoder_spec, contrastive_loss
    params, _, batch = args
    new_params, _, metrics = out
    shape = registry.get("dr-bert-base").shapes["train_contrastive"]
    enc = biencoder_spec(registry.get("dr-bert-base").full_config(),
                         q_max_len=shape["q_len"], p_max_len=shape["p_len"])
    with torch.no_grad():
        loss, _ = contrastive_loss(params, enc, batch)
    rel = abs(float(metrics["loss"]) - float(loss)) / abs(float(loss))
    leaves = list(zip(pytree.tree_leaves(params),
                      pytree.tree_leaves(new_params)))
    finite = all(bool(torch.isfinite(b).all()) for _, b in leaves)
    changed = sum(bool((a != b).any()) for a, b in leaves)
    gate = {"loss": float(metrics["loss"]), "loss_separate": float(loss),
            "rel": rel, "leaves": len(leaves), "finite": finite,
            "changed": changed}
    check(rel <= 1e-5 and finite and changed == len(leaves),
          f"train_contrastive: {gate}")
    return lambda: gate


def launch_cell_part(device, shape_name, hw, host="dry run running",
                     trace=False):
    """(b) One of the paper's cells at full shape on the card:
    ``build_step("dr-bert-base", shape, make_validator_mesh(1))``, its
    arguments materialised (:func:`launch_args`), ``spec.fn`` warmed up
    and timed (median of five by CUDA events), the peak memory, the port's
    roofline of the same cell at one device (``analysis.measure`` on a
    one-device meta mesh), model flops per second as a share of the
    card's peaks, and the cell's gate; no kernel launch.  ``host`` names
    what else ran on the host meanwhile; ``trace`` adds one call under the
    profiler (device time by kernel, busy and idle share).  Returns a
    callable that finishes the gate and prints the cell's line (the
    encode gate's CPU run can wait for a quiet host)."""
    from repro_torch.distributed import compat
    from repro_torch.launch import analysis
    from repro_torch.launch.mesh import make_validator_mesh
    from repro_torch.launch.steps import build_step
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spec = build_step("dr-bert-base", shape_name,
                      make_validator_mesh(1, device=device.type))
    one = compat.make_mesh((1, 1), ("data", "model"), [torch.device("meta")])
    m = analysis.measure(build_step("dr-bert-base", shape_name, one), 1, hw)
    mf = spec.meta["model_flops"]
    roof = analysis.roofline(m, mf, hw)
    args = launch_args(spec, device, seed=8)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    grad = torch.enable_grad if spec.kind == "train" else \
        torch.inference_mode
    with grad():
        out, first_s = timed(lambda: spec.fn(*args))
        for _ in range(LAUNCH_WARMUP - 1):
            spec.fn(*args)
        ms = call_times_ms(lambda: spec.fn(*args))
    torch.cuda.synchronize()
    launches = all_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gate = launch_gate(shape_name, spec, args, out)
    sec = ms["median"] / 1e3
    row = {"phase": "launch", "part": "b", "cell": spec.cell,
           "kind": spec.kind, "ms": ms, "first_call_s": first_s,
           "warmup": LAUNCH_WARMUP, "peak_gb": peak_gb,
           "model_flops": mf, "tokens": spec.meta["tokens"],
           "share_bf16_peak": mf / sec / hw.peak_flops,
           "roofline": {key: roof[key] for key in (
               "step_time_s", "bottleneck", "compute_s", "memory_s",
               "memory_raw_s", "compute_typed_s", "step_time_typed_s")},
           "roofline_flops": m.flops, "roofline_hbm_bytes": m.hbm_bytes_est,
           "step_time_over_ms": roof["step_time_s"] / sec,
           "step_time_typed_over_ms": roof["step_time_typed_s"] / sec,
           "setup_s": setup_s, "launches": launches, "host": host,
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": nvidia_smi()}
    if spec.kind == "retrieval":            # an f32 product
        row["share_f32_peak"] = mf / sec / hw.peak_f32
    check(not any(launches.values()),
          f"{spec.cell}: the step launched a kernel: {launches}")
    if trace:
        with grad():
            emit(traced(f"launch_{shape_name}", lambda: spec.fn(*args), ()))
    del args, out

    def finish():
        row["gate"] = gate()
        emit(row)

    return finish


def launch_phase(device, trace: bool = False):
    """Phase 8: (a) the dry run of every launch cell, on the host's cores,
    while (b) times the paper's three dr-bert-base cells at full shape on
    the card (each bound by the card, not by the host).  ``trace`` runs
    (b) once more after (a) has ended, each cell with a profiled call."""
    from repro_torch.launch import analysis
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    run = launch_dryrun_start()
    try:
        hw = analysis.h100_sxm()
        finish = [launch_cell_part(device, shape_name, hw)
                  for shape_name in PAPER_CELLS]
        launch_dryrun_finish(run)
    finally:
        launch_dryrun_stop(run)
    for done in finish:                     # the encode gate's CPU run
        done()
    if trace:
        for shape_name in PAPER_CELLS:
            launch_cell_part(device, shape_name, hw, host="quiet",
                             trace=True)()
    emit({"phase": "launch", "ok": True,
          "seconds": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
# Phase 9: the examples' torch twins
# ---------------------------------------------------------------------------

EXAMPLE_TWINS = ("quickstart", "train_with_control", "lazy_handoff",
                 "async_vs_sync", "subset_fidelity", "multi_task_validation",
                 "serve_live", "fleet_validation", "distributed_validation",
                 "observability", "recsys_asyncval")


def load_twin(name):
    """``examples/<name>_torch.py`` as a module (the examples are not a
    package)."""
    import importlib.util
    path = os.path.join(ROOT, "examples", f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twin_summary(name, out):
    """What the original example prints, from its twin's return value."""
    if name == "quickstart":
        return {"subset_size": out["subset_size"],
                "n_chunks": out["n_chunks"], "best_step": out["best_step"],
                "metrics": {r["step"]: r["metrics"]
                            for r in out["results"]}}
    if name == "train_with_control":
        ens = out["ensemble"]
        return {"stopped_early": out["stopped_early"],
                "stop_verdict": out["stop_verdict"],
                "trained_steps": out["trained_steps"],
                "best_step": out["best_step"],
                "kept_checkpoints": out["kept_checkpoints"],
                "ensemble": ens and {k: ens[k] for k in
                                     ("step", "members", "metrics")},
                "events": len(out["event_kinds"]),
                "event_kinds": sorted(set(out["event_kinds"]))}
    if name == "lazy_handoff":
        return {key: out[key] for key in (
            "watcher_p50_s", "handoff_p50_s", "gap", "n_verdicts",
            "n_snapshot", "parity")}
    if name == "async_vs_sync":
        return {"speedup": out["speedup"], "rows": [
            {key: r[key] for key in ("mode", "total_s", "train_s",
                                     "validate_s", "n_validated",
                                     "mrr_last")} for r in out["rows"]]}
    if name == "subset_fidelity":
        fid = out["fidelity"]
        return {"full": fid["full"]["curve"], "subsets": {
            key: {k: fid[key][k] for k in ("size", "spearman",
                                           "mean_delta",
                                           "best_ckpt_agreement")}
            for key in fid if key != "full"}}
    if name == "multi_task_validation":
        return {"best_step": out["best_step"],
                "best_value": out["best_value"], "stop": out["stop"],
                "metrics": [(r["step"], r["task"], r["metrics"]["MRR@10"])
                            for r in out["rows"]]}
    if name == "serve_live":
        return {key: out[key] for key in (
            "n_responses", "drops", "swaps", "served", "live_step",
            "removed")}
    if name == "fleet_validation":
        return {"validated_steps": out["validated_steps"],
                "units_by_worker": {w: len(u) for w, u in
                                    out["units_by_worker"].items()},
                "best_step": out["best_step"],
                "decisions_replayed": len(out["decisions"])}
    if name == "distributed_validation":
        return {key: out[key] for key in ("agree", "chunked_items",
                                          "chunked_s")}
    if name == "observability":
        return {key: out[key] for key in (
            "n_events", "workers_tracing", "served_step",
            "ckpt_to_verdict_p50_s", "ckpt_to_verdict_p99_s",
            "n_verdicts")} | {"stages": len(out["stages"])}
    return {"metrics": {r["step"]: r["metrics"] for r in out["results"]}}


def examples_phase(device):
    """Phase 9: each example's torch twin (``examples/<name>_torch.py``)
    in this process on the card at its original's default sizes, its own
    asserts live; one line per twin with its seconds and what its original
    prints (its own output goes to ``build/chip_smoke/examples/<name>.log``).
    Then the quickstart again with ``impl="cuda"``: its topk_mips launches
    (one per corpus chunk and checkpoint), and its metrics within 1e-6 of
    the torch route's.  Returns those launches."""
    t_phase = time.perf_counter()
    root = os.path.join(WORK, "examples")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    outs = {}

    def run(name, tag=None, **kw):
        tag = tag or name
        twin = load_twin(name)
        params = dict(device=device.type, **kw)
        if "workdir" in twin.main.__kwdefaults__:
            params["workdir"] = os.path.join(root, tag)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with open(os.path.join(root, f"{tag}.log"), "w") as log, \
                contextlib.redirect_stdout(log):
            out = twin.main(**params)
        seconds = time.perf_counter() - t0
        emit({"phase": "examples", "name": tag, "seconds": seconds,
              **twin_summary(name, out)})
        outs[tag] = out
        return out

    for name in EXAMPLE_TWINS:
        run(name)
    reset_all_launches()
    quick = run("quickstart", tag="quickstart_cuda", impl="cuda")
    launches = all_launches()
    want = {key: 0 for key in launches}
    want["topk_mips_f32"] = quick["n_chunks"] * quick["n_validated"]
    check(launches == want, f"quickstart impl=cuda: kernel launches "
          f"{launches}, expected {want}")
    for a, b in zip(outs["quickstart"]["results"], quick["results"]):
        for key, v in a["metrics"].items():
            check(abs(v - b["metrics"][key]) <= 1e-6,
                  f"quickstart step {a['step']} {key}: torch {v} vs cuda "
                  f"{b['metrics'][key]}")
    emit({"phase": "examples", "ok": True, "twins": len(EXAMPLE_TWINS),
          "quickstart_cuda_launches": launches["topk_mips_f32"],
          "seconds": time.perf_counter() - t_phase})
    return launches["topk_mips_f32"]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    device = torch.device("cuda:0")
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch_device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          **build_kernels()})
    emit(flash_instantiations())
    emit(topk_instantiations())
    emit(decode_instantiations())
    rows, whole_rows, quick_row = kernel_phase(device)
    flash_rows, flash_arctic = flash_kernel_phase(device)
    decode_rows, decode_arctic = decode_kernel_phase(device)
    # launches come only from the paths' runs; without them, none
    launches = {dt: None for dt in rows}
    whole_launches = {dt: None for dt in whole_rows}
    flash_launches = {dt: None for dt in flash_rows}
    decode_launches = {dt: None for dt in decode_rows}
    family_launches = {f"{kind}_{dt}": None for kind in ("flash", "decode")
                       for dt in TORCH_DT}
    serve_rows = {}
    fleet_launches = {dt: None for dt in FLEET_DTYPES}
    quickstart_launches = None
    if "--train-only" in argv:
        ds = write_dataset()
        lexical_subset(ds)
        train_phase(device, ds, trace="--trace" in argv)
    elif "--serve-only" in argv:
        ds = write_dataset()
        launches, main_results = main_phase(device, ds)
        serve_rows = serve_phase(device, ds, main_results)
    elif "--fleet-only" in argv:
        ds = write_dataset()
        launches, main_results = main_phase(device, ds)
        fleet_launches = fleet_phase(device, ds, main_results)
    elif "--families-only" in argv:
        family_launches = families_phase(device)
    elif "--launch-only" in argv:
        launch_phase(device, trace="--trace" in argv)
    elif "--examples-only" in argv:
        quickstart_launches = examples_phase(device)
    elif "--kernels-only" not in argv:
        encoder_phase(device)
        ds = write_dataset()
        launches, main_results = main_phase(device, ds)
        whole_launches = subset_phase(device, ds, main_results)
        serve_rows = serve_phase(device, ds, main_results)
        fleet_launches = fleet_phase(device, ds, main_results)
        if "--trace" in argv:
            trace_phase()
        train_phase(device, ds, trace="--trace" in argv)
        lm_launches = lm_phase(device, trace="--trace" in argv)
        flash_launches = {dt: lm_launches[dt] for dt in flash_rows}
        decode_launches = {dt: lm_launches[f"decode_{dt}"]
                           for dt in decode_rows}
        family_launches = families_phase(device)
        launch_phase(device, trace="--trace" in argv)
        quickstart_launches = examples_phase(device)
    emit({"kernels": [
        kernel_row(f"topk_mips_{dt}", SOURCE, REPLACES[dt], launches[dt],
                   row) for dt, row in rows.items()] + [
        kernel_row(f"topk_mips_{dt}_whole_corpus", SOURCE, REPLACES[dt],
                   whole_launches[dt], row)
        for dt, row in whole_rows.items()] + [
        kernel_row(f"topk_mips_{dt}_serve", SOURCE, REPLACES[dt],
                   row["launches"], row)
        for dt, row in serve_rows.items()] + [
        kernel_row(f"topk_mips_{dt}_fleet", SOURCE, REPLACES[dt],
                   fleet_launches[dt], rows[dt]) for dt in FLEET_DTYPES] + [
        kernel_row("topk_mips_f32_quickstart", SOURCE, REPLACES["f32"],
                   quickstart_launches, quick_row)] + [
        kernel_row(f"flash_attention_{dt}", FLASH_SOURCE, FLASH_REPLACES,
                   flash_launches[dt], row)
        for dt, row in flash_rows.items()] + [
        kernel_row(f"decode_attention_{dt}", DECODE_SOURCE, DECODE_REPLACES,
                   decode_launches[dt], row)
        for dt, row in decode_rows.items()] + [
        kernel_row(f"flash_attention_{dt}_arctic", FLASH_SOURCE,
                   FLASH_REPLACES, family_launches[f"flash_{dt}"], row)
        for dt, row in flash_arctic.items()] + [
        kernel_row(f"decode_attention_{dt}_arctic", DECODE_SOURCE,
                   DECODE_REPLACES, family_launches[f"decode_{dt}"], row)
        for dt, row in decode_arctic.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
