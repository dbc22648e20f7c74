"""Run the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py                # all phases (one card)
    python3 chip_smoke.py --kernels-only # build + kernel checks only
    python3 chip_smoke.py --trace        # all phases + a profiler trace

Phases, each printing one JSON line:

  1. device   — ``nvidia-smi`` name and power limit, the torch device name,
                and the nvcc build of the kernels from ``src/repro_torch/csrc``.
  2. kernels  — every topk_mips kernel (f32, bf16, int8) at the main path's
                shapes (Q=256 queries, D=768, a chunk of N=1024 rows, k=100
                and 1000, a ragged chunk, the engine carry) plus edge shapes,
                held against its plain PyTorch version on the card, and timed
                with CUDA events beside the plain version and a library
                yardstick (``torch.topk(q @ c.T)``, which the port never calls).
  3. encoder  — the full-width dr-bert-base trunk on the card against the same
                trunk on the CPU, in f32, on a few sequences.
  4. main     — the validator CLI (``repro_torch.core.cli.main``) on two
                seeded random full-width dr-bert-base checkpoints over a
                synthetic corpus of 8192 passages, for ``--impl cuda`` at
                f32, bf16 and int8 and ``--impl torch`` at f32: empty errors,
                one ledger row per step with the reference's keys, one kernel
                launch per corpus chunk and checkpoint, and equal f32 metrics
                between the two impls.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero before that line.  It needs a CUDA device and the
checkout's ``src/`` beside it; scratch files go to ``build/chip_smoke/``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# One H100 SXM, NVIDIA's data sheet (dense): HBM rate and peak rates by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
ELEM_BYTES = {"f32": 4, "bf16": 2, "int8": 1}
REPLACES = {"f32": "src/repro/kernels/topk_mips/kernel.py:135",
            "bf16": "src/repro/kernels/topk_mips/kernel.py:135",
            "int8": "src/repro/kernels/topk_mips/kernel.py:176"}
SOURCE = "src/repro_torch/csrc/topk_mips.cu"
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

        # the main path's call: one chunk folded into the engine carry
        for k in (100, 1000):
            for n_valid in (N, 700):
                q, c = rand(Q, D), rand(N, D)
                run_s, run_i = ops.topk_mips_chunk(
                    q, rand(N, D), torch.full((Q, k), float("-inf"),
                                              device=device),
                    torch.zeros((Q, k), dtype=torch.int32, device=device),
                    base=0, score_dtype=dt)
                qk, ck, qs, cs = plain_inputs(dt, q, c)
                base = 5 * N

                def kernel():
                    return ops._topk_cuda(dt, qk, ck, qs, cs, k_target=k,
                                          n_valid=n_valid,
                                          carry=(run_s, run_i), base=base)

                def plain():
                    return plain_chunk(dt, qk, ck, qs, cs, run_s, run_i,
                                       base, n_valid)

                got = ops.topk_mips_chunk(q, c, run_s, run_i, base=base,
                                          n_valid=n_valid, score_dtype=dt)
                torch.cuda.synchronize()
                err = compare(dt, got, plain())
                compare(dt, kernel(), got, exact_ties=True)
                ms, plain_ms = cuda_time_ms(kernel), cuda_time_ms(plain)
                library_ms = cuda_time_ms(
                    lambda: library_call(dt, qk, ck, qs, cs, k))
                nbytes = (Q + N) * D * ELEM_BYTES[dt] + 4 * Q * k * 4
                if dt == "int8":
                    nbytes += (Q + N) * 4
                t_bytes = nbytes / HBM_BYTES_S * 1e3
                t_ops = 2 * Q * n_valid * D / PEAK_OPS_S[dt] * 1e3
                row = {"phase": "kernels", "variant": dt, "Q": Q, "N": N,
                       "n_valid": n_valid, "D": D, "k": k,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations"}
                emit(row)
                if k == 100 and n_valid == N:
                    rows[dt] = row
    emit({"phase": "kernels", "ok": True,
          "checked_launches": dict(ops.launches)})
    return rows


# ---------------------------------------------------------------------------
# phase 3: the full-width encoder on the card against the CPU
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
# phase 4: the validator CLI on full-width checkpoints
# ---------------------------------------------------------------------------


def main_phase(device):
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import dr_bert_base
    from repro_torch.core import cli
    from repro_torch.data import corpus as corpus_lib
    from repro_torch.kernels.topk_mips import ops
    from repro_torch.models import transformer as tfm

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "corpus"))
    cfg = dr_bert_base.full_config()
    n_docs, chunk, steps = 8192, 1024, (1000, 2000)
    ds = corpus_lib.synthetic_retrieval_dataset(
        0, n_passages=n_docs, n_queries=256, vocab=cfg.vocab_size,
        p_len=128, q_len=32)
    corpus_lib.write_jsonl(os.path.join(work, "corpus", "c.jsonl"),
                           ds.corpus)
    corpus_lib.write_jsonl(os.path.join(work, "q.jsonl"), ds.queries)
    with open(os.path.join(work, "qrels.txt"), "w") as f:
        for qid, docs in ds.qrels.items():
            for did, g in docs.items():
                f.write(f"{qid} 0 {did} {g}\n")
    t0 = time.perf_counter()
    for i, step in enumerate(steps):
        ckpt.save(os.path.join(work, "ckpts"), step,
                  {"params": tfm.init_numpy(cfg, i + 1)})
    emit({"phase": "main", "setup": "checkpoints", "steps": list(steps),
          "seconds": time.perf_counter() - t0})

    n_chunks = -(-n_docs // chunk)
    results, measured = {}, {}
    for impl, dt in (("cuda", "f32"), ("cuda", "bf16"), ("cuda", "int8"),
                     ("torch", "f32")):
        out = os.path.join(work, f"out_{impl}_{dt}")
        ops.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main([
            "--query_file", os.path.join(work, "q.jsonl"),
            "--candidate_dir", os.path.join(work, "corpus"),
            "--ckpts_dir", os.path.join(work, "ckpts"),
            "--qrel_file", os.path.join(work, "qrels.txt"),
            "--q_max_len", "32", "--p_max_len", "128",
            "--metrics", "MRR@10", "Recall@100",
            "--impl", impl, "--score_dtype", dt, "--chunk_size", str(chunk),
            "--batch_size", "256", "--output_dir", out])
        seconds = time.perf_counter() - t0
        counts = dict(ops.launches)
        check(rc == 0, f"cli {impl}/{dt} returned {rc} (validation errors)")
        with open(os.path.join(out, "asyncval_ledger.jsonl")) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        check([r["step"] for r in rows] == list(steps),
              f"{impl}/{dt}: ledger steps {[r['step'] for r in rows]}")
        for r in rows:
            check(set(r) == LEDGER_KEYS, f"{impl}/{dt}: ledger keys "
                  f"{sorted(r)}")
            check(r["score_dtype"] == dt and r["engine"] == "streaming",
                  f"{impl}/{dt}: row {r['engine']}/{r['score_dtype']}")
            check(all(math.isfinite(v) for v in r["metrics"].values()),
                  f"{impl}/{dt}: metrics {r['metrics']}")
        want = {key: 0 for key in counts}
        if impl == "cuda":
            want[dt] = n_chunks * len(steps)
        check(counts == want, f"{impl}/{dt}: kernel launches {counts}, "
              f"expected {want}")
        results[(impl, dt)] = rows
        if impl == "cuda":
            measured[dt] = counts[dt]
        emit({"phase": "main", "impl": impl, "score_dtype": dt,
              "launches": counts, "seconds": seconds,
              "metrics": {r["step"]: r["metrics"] for r in rows},
              "timings": {r["step"]: r["timings"] for r in rows}})
    for a, b in zip(results[("cuda", "f32")], results[("torch", "f32")]):
        for name, v in a["metrics"].items():
            check(abs(v - b["metrics"][name]) <= 1e-6,
                  f"step {a['step']} {name}: cuda {v} vs torch "
                  f"{b['metrics'][name]}")
    return measured


def trace_phase():
    """One ``--impl cuda --score_dtype bf16`` validation of one checkpoint
    under ``torch.profiler``.  From the exported Chrome trace: device time
    by kernel, the topk_mips kernels' share, and the device's busy time
    (union of kernel, memcpy and memset intervals) against the wall time of
    the CLI call, which includes the restore from disk."""
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        check(cli.main(args) == 0, "traced cli run failed")
        wall = time.perf_counter() - t0
    path = os.path.join(work, "trace_bf16.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    check(bool(dev), "the trace holds no device activity")
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo = busy + hi - lo, s
        hi = max(hi, e)
    busy += hi - lo
    by_name: dict = {}
    for e in dev:
        name = e["name"][:90]
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + e["dur"], n + 1)
    mips_us = sum(e["dur"] for e in dev if "mips_tile_topk" in e["name"]
                  or "merge_topk" in e["name"])
    emit({"phase": "trace", "wall_s": wall, "device_busy_s": busy / 1e6,
          "device_span_s": (spans[-1][1] - spans[0][0]) / 1e6,
          "idle_share_of_wall": 1 - busy / 1e6 / wall,
          "topk_mips_ms": mips_us / 1e3,
          "top": [{"name": n, "device_ms": t / 1e3, "count": c}
                  for n, (t, c) in sorted(by_name.items(),
                                          key=lambda kv: -kv[1][0])[:12]]})


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    device = torch.device("cuda:0")
    smi = nvidia_smi()
    from repro_torch.kernels import build
    from repro_torch.kernels.topk_mips import ops
    t0 = time.perf_counter()
    ops._lib()
    info = build.BUILD_INFO["topk_mips"]
    emit({"phase": "device", "nvidia_smi": smi,
          "torch_device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0, "nvcc_s": info["seconds"],
          "ptxas": [ln for ln in info["log"].splitlines()
                    if "registers" in ln or "spill" in ln]})
    rows = kernel_phase(device)
    # launches come only from the main path's run; without it, none
    launches = {dt: None for dt in rows}
    if "--kernels-only" not in argv:
        encoder_phase(device)
        launches = main_phase(device)
        if "--trace" in argv:
            trace_phase()
    emit({"kernels": [
        {"name": f"topk_mips_{dt}", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[dt], "launches": launches[dt],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        for dt, row in rows.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
