"""Run the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py                # all phases (one card)
    python3 chip_smoke.py --kernels-only # build + the kernel phases only
    python3 chip_smoke.py --trace        # all phases + profiler traces of
                                         # one validation, one LM forward
                                         # and one decode_32k decode step

Phases, each printing one JSON line:

  1. device   — ``nvidia-smi`` name and power limit, the torch device name,
                and the nvcc builds of the kernels from ``src/repro_torch/csrc``
                (one nvcc per source, started together); then a
                ``flash_build`` line: each flash instantiation's ptxas
                registers and spill bytes and its count of ``HGMMA``
                (tensor-core) instructions from ``cuobjdump -sass`` (every
                bf16 instantiation must have some and spill nothing); then a
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
                kernel's own.
  3. flash    — the flash-attention kernel (f32, bf16) at the LM path's shape
                (B=4, H=14, KV=2, S=T=2048, d=64, causal, on the trunk's
                strided views) and, at bf16, the qwen2-72b head geometry
                (B=1, H=64, KV=8, S=T=2048, d=128), plus the reference's
                kernel-test cases, held against its plain version on the
                card, and timed beside it and
                ``scaled_dot_product_attention`` (the yardstick only).
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
                between the two impls.
  6. lm       — full-width qwen2-0.5b (24 layers, random weights from a seed):
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

Kernel launches are counted only while a path runs (the main path for
topk_mips, the LM phase's ``lm_loss`` for flash attention, its
``serve_batch`` calls for decode attention: the three timed bf16 calls and
the f32 one), with every count set to 0 just before it.  Then a
``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``.
Any failed check raises, so the script exits non-zero before that line.  It
needs a CUDA device and the checkout's ``src/`` beside it; scratch files go
to ``build/chip_smoke/``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
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
                dev_ms, by_kernel = device_ms(f"topk_{dt}_{k}_{n_valid}",
                                              kernel, TOPK_KERNELS)
                library_ms = cuda_time_ms(
                    lambda: library_call(dt, qk, ck, qs, cs, k))
                nbytes = (Q + N) * D * ELEM_BYTES[dt] + 4 * Q * k * 4
                if dt == "int8":
                    nbytes += (Q + N) * 4
                t_bytes = nbytes / HBM_BYTES_S * 1e3
                t_ops = 2 * Q * n_valid * D / PEAK_OPS_S[dt] * 1e3
                row = {"phase": "kernels", "variant": dt, "Q": Q, "N": N,
                       "n_valid": n_valid, "D": D, "k": k,
                       "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                       "device_ms_by_kernel": by_kernel,
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations"}
                emit(row)
                if k == 100 and n_valid == N:
                    rows[dt] = row
    emit({"phase": "kernels", "ok": True,
          "checked_launches": dict(ops.launches),
          "seconds": time.perf_counter() - t_phase})
    return rows


# ---------------------------------------------------------------------------
# phase 3: flash attention against its plain version
# ---------------------------------------------------------------------------

# the LM path's shape: qwen2-0.5b heads, batch 4 x 2048 tokens, causal
FLASH_PATH = (4, 14, 2, 2048, 2048, 64, True)
# a second timed bf16 row: qwen2-72b heads (d=128), one sequence of 2048
FLASH_D128 = (1, 64, 8, 2048, 2048, 128, True)
# the cases of tests/test_kernels.py (flash_attention_matches_ref)
FLASH_CASES = [(2, 4, 2, 64, 64, 32, True), (1, 8, 8, 33, 57, 64, False),
               (2, 2, 1, 128, 256, 128, True), (1, 14, 2, 40, 40, 64, True)]


def flash_bound_ms(dt, B, H, KV, S, T, d, causal, t_valid):
    """Least time for the work: each input read once and the output written
    once, against the operations on the pairs the mask leaves.  At bf16 the
    kernel's arithmetic is three bf16 tensor-core products of 2 * pairs * d
    FLOP per head (q . k, p_hi . v, p_lo . v: p split in two bf16 halves so
    it keeps f32 precision); at f32 two products at the f32 rate."""
    nbytes = (2 * B * H * S * d + 2 * B * KV * T * d) * ELEM_BYTES[dt]
    if causal:
        pairs = sum(min(i + 1, t_valid) for i in range(S))
    else:
        pairs = S * t_valid
    flop = 2 * B * H * pairs * d
    t_ops = (3 if dt == "bf16" else 2) * flop / PEAK_OPS_S[dt]
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

    rows = {}
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

        # the LM path (and at bf16 the d=128 row): transposed views of
        # (B, S, H, d), as the trunk passes them
        for name, shape in [("path", FLASH_PATH)] + (
                [("qwen2_72b_heads", FLASH_D128)] if dt == "bf16" else []):
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
            emit(row)
            if name == "path":
                rows[dt] = row
            del q, k, v, got
    emit({"phase": "flash", "ok": True,
          "checked_launches": dict(ops.launches),
          "seconds": time.perf_counter() - t_phase})
    return rows


# ---------------------------------------------------------------------------
# phase 3b: decode attention against its plain version
# ---------------------------------------------------------------------------

# (name, B, KV, G, d, T capacity, length): the serve path (qwen2-0.5b heads,
# batch 4, prompt 128 + gen 16), one layer of qwen2-0.5b at decode_32k and
# at long_500k (full, and the kernel docstring's 32k prefix), and the
# qwen2-72b / deepseek-67b attention geometry; all read the trunk's
# transposed (B, T, KV, d) cache views
DECODE_SHAPES = [("serve", 4, 2, 7, 64, 144, 128),
                 ("serve", 4, 2, 7, 64, 144, 143),
                 ("decode_32k", 128, 2, 7, 64, 32768, 32768),
                 ("long_500k", 1, 2, 7, 64, 524288, 524288),
                 ("long_500k_prefix_32k", 1, 2, 7, 64, 524288, 32768),
                 ("qwen2_72b", 8, 8, 8, 128, 32768, 32768)]
# the shape of the kernels line: the decode_32k layer
DECODE_MAIN = "decode_32k"
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
    rows = {}
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
            del q, k, v, got
            torch.cuda.empty_cache()
        emit({"phase": "decode", "variant": dt, "checked": len(errs),
              "worst_err": max(errs),
              "worst_excess_over_half_ulp": None if dt == "f32"
              else max(excesses)})
    emit({"phase": "decode", "ok": True,
          "checked_launches": dict(ops.launches),
          "seconds": time.perf_counter() - t_phase})
    return rows


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


def main_phase(device):
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import dr_bert_base
    from repro_torch.core import cli
    from repro_torch.data import corpus as corpus_lib
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
        reset_all_launches()
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
        counts = all_launches()
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
            want[f"topk_mips_{dt}"] = n_chunks * len(steps)
        check(counts == want, f"{impl}/{dt}: kernel launches {counts}, "
              f"expected {want}")
        results[(impl, dt)] = rows
        if impl == "cuda":
            measured[dt] = counts[f"topk_mips_{dt}"]
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


def row_cosine(a, b) -> float:
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    return float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)))
                 .min())


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
        cfg = dataclasses.replace(full, attn_impl="cuda")
        with torch.inference_mode():
            emit(traced("lm_forward_bf16",
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


def device_params(cfg, seed: int, device):
    """Random parameters made on the card from a seed, with the scheme of
    ``transformer.init_numpy`` (norm scales 1, biases 0, tables N(0, 0.02),
    weights N(0, 1/fan_in)): the 17 GB of a 2-layer qwen2-72b are made in a
    second instead of a minute of host sampling and upload."""
    from repro_torch.models import transformer as tfm
    gen = torch.Generator(device=device).manual_seed(seed)

    def build(node, name):
        if isinstance(node, dict):
            return {key: build(node[key], key) for key in sorted(node)}
        if name == "scale":
            return torch.ones(node, device=device)
        if name in ("bias", "b", "bq", "bk", "bv"):
            return torch.zeros(node, device=device)
        std = 0.02 if name == "table" else 1.0 / math.sqrt(node[-2])
        return torch.randn(node, generator=gen, device=device).mul_(std)

    return build(tfm.param_shapes(cfg), "")


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
    ``names`` (label -> regex): its ptxas registers and spill bytes, and the
    count of its tensor-core instructions by mnemonic (warpgroup MMA:
    ``HGMMA``, ``IGMMA``, ...; warp MMA: ``HMMA``) in its SASS from
    ``cuobjdump -sass`` of the built library ({} per kernel when it has
    none; None without cuobjdump)."""
    import re

    from repro_torch.kernels import build
    info = build.BUILD_INFO[lib]

    def label(ln):
        return next((k for k, pat in names.items() if re.search(pat, ln)),
                    None)

    out, cur = {}, None
    for ln in info["log"].splitlines():
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
    for rec in out.values():
        rec["gmma"] = None if sass is None else {}
    cur = None
    for ln in (sass or "").splitlines():
        if "Function :" in ln:
            cur = out.get(label(ln))
        elif cur is not None:
            m = re.search(r"\b([A-Z]GMMA|HMMA)\b", ln)
            if m:
                cur["gmma"][m[1]] = cur["gmma"].get(m[1], 0) + 1
    return out


def flash_instantiations():
    """Each flash instantiation's ptxas registers and spill bytes, and the
    count of ``HGMMA`` (wgmma) instructions in its SASS.  Every bf16
    instantiation must run on tensor cores and spill nothing."""
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
    recs = build_records("flash_attention", {
        f"flash_fwd_{dt}<{d}>": rf"flash_fwd_{dt}ILi{d}E"
        for dt in ("bf16", "f32") for d in HEAD_DIMS})
    for rec in recs.values():
        gmma = rec.pop("gmma")
        rec["hgmma"] = None if gmma is None else gmma.get("HGMMA", 0)
    for d in HEAD_DIMS:
        rec = recs.get(f"flash_fwd_bf16<{d}>", {})
        check(rec.get("spill_bytes") == 0, f"flash_fwd_bf16<{d}>: ptxas "
              f"reports {rec}")
        check(rec.get("hgmma", 1) != 0, f"flash_fwd_bf16<{d}> has no HGMMA "
              "in its SASS")
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
    if "device_ms" in row:
        out["device_ms"] = row["device_ms"]
    return out


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
    rows = kernel_phase(device)
    flash_rows = flash_kernel_phase(device)
    decode_rows = decode_kernel_phase(device)
    # launches come only from the paths' runs; without them, none
    launches = {dt: None for dt in rows}
    flash_launches = {dt: None for dt in flash_rows}
    decode_launches = {dt: None for dt in decode_rows}
    if "--kernels-only" not in argv:
        encoder_phase(device)
        launches = main_phase(device)
        if "--trace" in argv:
            trace_phase()
        lm_launches = lm_phase(device, trace="--trace" in argv)
        flash_launches = {dt: lm_launches[dt] for dt in flash_rows}
        decode_launches = {dt: lm_launches[f"decode_{dt}"]
                           for dt in decode_rows}
    emit({"kernels": [
        kernel_row(f"topk_mips_{dt}", SOURCE, REPLACES[dt], launches[dt],
                   row) for dt, row in rows.items()] + [
        kernel_row(f"flash_attention_{dt}", FLASH_SOURCE, FLASH_REPLACES,
                   flash_launches[dt], row)
        for dt, row in flash_rows.items()] + [
        kernel_row(f"decode_attention_{dt}", DECODE_SOURCE, DECODE_REPLACES,
                   decode_launches[dt], row)
        for dt, row in decode_rows.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
