"""Time one hand-written kernel of one or more checkouts on one GPU.

    python3 tools/kernel_ab.py flash ROOT [ROOT ...] [--lm]
    python3 tools/kernel_ab.py decode ROOT [ROOT ...] [--plans]
    python3 tools/kernel_ab.py train ROOT [ROOT ...] [--deterministic]

Each ROOT is a checkout (its ``src/`` holds ``repro_torch``), for example
the parent commit unpacked with ``git archive`` into a git-ignored
directory.  Each one runs in a process of its own, in the order given, so
``parent . . parent`` compares two versions in turns on one card.  For each
ROOT, dtype and shape of the kernel's table (the shapes of its rows in
``chip_smoke.py``, on the trunk's transposed views), one JSON line: ``ms``
(CUDA events around 20 back-to-back wrapper calls after 3 warm-ups) and
``device_ms_by_kernel`` (each of the kernel's CUDA kernels' device time per
call from a ``torch.profiler`` window over 20 calls), with ``device_ms``
their sum.

* ``flash``: f32 and bf16 at the LM path's shape (B=4, H=14, KV=2,
  S=T=2048, d=64) and the qwen2-72b heads (B=1, H=64, KV=8, S=T=2048,
  d=128), both causal; each line adds ``max_abs_err``, the largest |kernel -
  plain version| on its inputs.  ``--lm`` adds, per dtype, full-width
  qwen2-0.5b (24 layers, random weights from a seed) ``forward`` and
  ``lm_loss`` on 4 x 2048 tokens with ``attn_impl="cuda"``: the median,
  least and most of five calls after a warm-up, each between two CUDA
  events.
* ``decode``: bf16 and f32 at one qwen2-0.5b layer at decode_32k and
  long_500k, its 32k prefix and the qwen2-72b geometry; then the wrapper's
  host time per call at the serve shape (500 calls, no synchronisation).
  ``--plans`` adds, for a ROOT that has ``ops.split_plan``, the long_500k
  layer under plans for 1 to 4 waves of the device's resident blocks.
* ``train``: no kernel of its own: full-width dr-bert-base training steps
  as ``chip_smoke.py``'s train phase runs them (f32, AdamW with its
  warmup, temperature 0.05, 16 queries x 2 passages of 128 tokens):
  ``step_ms`` (median, least and most of 10 steps, each from its start to
  the host read of its loss), and from a ``torch.profiler`` window over 2
  steps the device time and the kernel launches per step and the 8 kernels
  with the most device time.  ``--deterministic`` runs the steps under
  ``torch.use_deterministic_algorithms``, as the train phase does.

The first line is ``nvidia-smi``'s name and power limit.  Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# (name, B, H, KV, S, T, d, causal), as chip_smoke.FLASH_PATH / FLASH_D128
FLASH_SHAPES = [("path", 4, 14, 2, 2048, 2048, 64, True),
                ("qwen2_72b_heads", 1, 64, 8, 2048, 2048, 128, True)]
# (name, B, KV, G, d, T capacity, length), as chip_smoke.DECODE_SHAPES
DECODE_SHAPES = [("decode_32k", 128, 2, 7, 64, 32768, 32768),
                 ("long_500k", 1, 2, 7, 64, 524288, 524288),
                 ("long_500k_prefix_32k", 1, 2, 7, 64, 524288, 32768),
                 ("qwen2_72b", 8, 8, 8, 128, 32768, 32768)]
# kernel -> (names in the profiler's kernel records, its extra flag)
KERNELS = {"flash": (("flash_fwd",), "--lm"),
           "decode": (("decode_split", "decode_merge"), "--plans"),
           "train": ((), "--deterministic")}


class Bench:
    """The timers and the output of one child process."""

    def __init__(self, root: str, names):
        import torch
        self.torch, self.root, self.names = torch, root, names
        self.dev = torch.device("cuda:0")
        self.gen = torch.Generator(device=self.dev).manual_seed(3)
        self.dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}

    def event_ms(self, fn, iters=20):
        torch = self.torch
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

    def device_ms(self, fn, iters=20):
        from torch.profiler import ProfilerActivity, profile
        fn()
        self.torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            self.torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            for name in self.names:
                if name in e.key:
                    out[name] = (out.get(name, 0.0)
                                 + e.device_time_total / 1e3 / iters)
        return out

    def timed(self, fn, **row):
        by_kernel = self.device_ms(fn)
        self.emit(**row, ms=self.event_ms(fn),
                  device_ms=sum(by_kernel.values()),
                  device_ms_by_kernel=by_kernel)

    def randn(self, *shape, dt):
        return self.torch.randn(*shape, generator=self.gen, device=self.dev,
                                dtype=self.dtypes[dt])

    def emit(self, **row):
        print(json.dumps({"root": self.root, **row}), flush=True)


def flash(bench: Bench, lm: bool) -> None:
    from repro_torch.kernels.flash_attention import ops, ref

    torch = bench.torch
    for dt in ("f32", "bf16"):
        for (name, B, H, KV, S, T, d, causal) in FLASH_SHAPES:
            q, k, v = (bench.randn(B, L, n, d, dt=dt).transpose(1, 2)
                       for L, n in ((S, H), (T, KV), (T, KV)))

            def call():
                return ops.flash_attention(q, k, v, causal=causal)

            err = float((call().float() - ref.flash_attention_ref(
                q, k, v, causal=causal).float()).abs().max())
            bench.timed(call, dtype=dt, shape=name, max_abs_err=err)
            del q, k, v
            torch.cuda.empty_cache()
    if not lm:
        return
    import dataclasses

    import numpy as np

    from repro_torch.configs import qwen2_0_5b
    from repro_torch.models import transformer as tfm
    full = qwen2_0_5b.full_config()
    params = tfm.params_from_numpy(tfm.init_numpy(full, 13), bench.dev)
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        1, full.vocab_size, (4, 2048)).astype(np.int32)).to(bench.dev)

    def call_ms(fn, n=5):
        fn()
        ms = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        return {"median": statistics.median(ms), "min": min(ms),
                "max": max(ms)}

    for dt in ("f32", "bf16"):
        cfg = dataclasses.replace(full, compute_dtype=bench.dtypes[dt],
                                  attn_impl="cuda")
        with torch.inference_mode():
            bench.emit(
                dtype=dt, shape="lm_qwen2_0_5b_4x2048",
                forward_ms=call_ms(lambda: tfm.forward(params, cfg, tokens)),
                lm_loss_ms=call_ms(lambda: tfm.lm_loss(
                    params, cfg, {"tokens": tokens})))


def decode(bench: Bench, plans: bool) -> None:
    from repro_torch.kernels.decode_attention import ops

    torch = bench.torch

    def cache(B, KV, T, d, dt):
        return bench.randn(B, T, KV, d, dt=dt).transpose(1, 2)

    for dt in ("bf16", "f32"):
        for (name, B, KV, G, d, T, L) in DECODE_SHAPES:
            q = bench.randn(B, KV, G, d, dt=dt)
            k, v = cache(B, KV, T, d, dt), cache(B, KV, T, d, dt)
            bench.timed(lambda: ops.decode_attention(q, k, v, L), dtype=dt,
                        shape=name)
            del q, k, v
            torch.cuda.empty_cache()
    for dt in ("bf16", "f32"):
        q = bench.randn(4, 2, 7, 64, dt=dt)
        k = cache(4, 2, 144, 64, dt)
        for _ in range(50):
            ops.decode_attention(q, k, k, 143)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            ops.decode_attention(q, k, k, 143)
        host_us = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
        bench.emit(dtype=dt, shape="serve", host_us_per_call=host_us)
    if not (plans and hasattr(ops, "split_plan")):
        return
    for dt in ("bf16", "f32"):
        q = bench.randn(1, 2, 7, 64, dt=dt)
        k, v = cache(1, 2, 524288, 64, dt), cache(1, 2, 524288, 64, dt)

        def call():
            return ops.decode_attention(q, k, v, 524288)

        call()
        key = (dt, 64, 7, 0)
        slots = ops._SLOTS[key]
        try:
            for waves in (1, 2, 3, 4):
                ops._SLOTS[key] = waves * slots
                bench.timed(call, dtype=dt, shape="long_500k", waves=waves,
                            plan=ops.split_plan(q, 524288))
        finally:
            ops._SLOTS[key] = slots
        del q, k, v
        torch.cuda.empty_cache()


def train(bench: Bench, deterministic: bool) -> None:
    import dataclasses

    from repro_torch.configs import dr_bert_base
    from repro_torch.data import corpus
    from repro_torch.launch.train import _contrastive_batches
    from repro_torch.models import transformer as tfm
    from repro_torch.models.biencoder import biencoder_spec, contrastive_loss
    from repro_torch.train import optim
    from repro_torch.train.trainer import make_train_step
    from torch.profiler import ProfilerActivity, profile

    torch = bench.torch
    if deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = False
    cfg = dataclasses.replace(dr_bert_base.full_config(),
                              compute_dtype=torch.float32)
    spec = biencoder_spec(cfg, q_max_len=32, p_max_len=128, device=bench.dev)
    ds = corpus.synthetic_retrieval_dataset(0, n_passages=8192,
                                            n_queries=256,
                                            vocab=cfg.vocab_size, p_len=128,
                                            q_len=32)
    make = _contrastive_batches(ds, spec, 16)
    batches = [make(i) for i in range(13)]
    opt = optim.adamw(optim.warmup_cosine(3e-5, 20, 240))
    step = make_train_step(
        lambda p, b: contrastive_loss(p, spec, b, temperature=0.05), opt)
    params = tfm.params_from_numpy(tfm.init_numpy(cfg, 11), bench.dev)
    state = [params, opt.init(params)]

    def one(i):
        state[0], state[1], m = step(state[0], state[1], batches[i])
        return float(m["loss"])

    one(0)
    ms = []
    for i in range(1, 11):
        t0 = time.perf_counter()
        one(i)
        ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one(11)
        one(12)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_time_total > 0]
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    bench.emit(shape="dr_bert_base_f32_16x2", deterministic=deterministic,
               step_ms={"median": statistics.median(ms), "min": min(ms),
                        "max": max(ms)},
               device_ms_per_step=sum(e.device_time_total
                                      for e in kernels) / 2e3,
               launches_per_step=sum(e.count for e in kernels) / 2,
               top=[{"name": e.key[:80], "device_ms": e.device_time_total
                     / 2e3, "count": e.count / 2} for e in top])


def main(argv) -> int:
    if len(argv) < 2 or argv[0] not in KERNELS:
        print(__doc__, file=sys.stderr)
        return 2
    kernel, args = argv[0], argv[1:]
    names, flag = KERNELS[kernel]
    extra = flag in args
    roots = [a for a in args if a != flag]
    if len(roots) == 2 and roots[0] == "--root":      # one child process
        sys.path.insert(0, os.path.join(os.path.abspath(roots[1]), "src"))
        {"flash": flash, "decode": decode,
         "train": train}[kernel](Bench(roots[1], names), extra)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for root in roots:
        cmd = [sys.executable, os.path.abspath(__file__), kernel, "--root",
               root] + ([flag] if extra else [])
        rc = subprocess.run(cmd).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
