"""Time the decode-attention kernel of one or more checkouts on one GPU.

    python3 tools/decode_attention_ab.py ROOT [ROOT ...] [--plans]

Each ROOT is a checkout (its ``src/`` holds ``repro_torch``), for example
the parent commit unpacked with ``git archive`` into a git-ignored
directory.  Each one runs in a process of its own, in the order given, so
``parent . . parent`` compares two versions in turns on one card.  For
each ROOT and dtype (bf16, f32), at the decode rows' path shapes of
``chip_smoke.py`` (one qwen2-0.5b layer at decode_32k and long_500k, its
32k prefix, the qwen2-72b geometry) on the trunk's transposed cache views,
one JSON line: ``ms`` (CUDA events around 20 back-to-back wrapper calls
after 3 warm-ups) and ``device_ms_by_kernel`` (``decode_split``,
``decode_merge``: device time per call from a ``torch.profiler`` window
over 20 calls); then the wrapper's host time per call at the serve shape
(500 calls, no synchronisation).  ``--plans`` adds, for a ROOT that has
``ops.split_plan``, the long_500k layer under plans for 1 to 4 waves of
the device's resident blocks.  The first line is ``nvidia-smi``'s name and
power limit.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# (name, B, KV, G, d, T capacity, length), as chip_smoke.DECODE_SHAPES
SHAPES = [("decode_32k", 128, 2, 7, 64, 32768, 32768),
          ("long_500k", 1, 2, 7, 64, 524288, 524288),
          ("long_500k_prefix_32k", 1, 2, 7, 64, 524288, 32768),
          ("qwen2_72b", 8, 8, 8, 128, 32768, 32768)]
KERNELS = ("decode_split", "decode_merge")


def run_one(root: str, plans: bool) -> None:
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention import ops

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(3)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}

    def event_ms(fn, iters=20):
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

    def device_ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            for name in KERNELS:
                if name in e.key:
                    out[name] = (out.get(name, 0.0)
                                 + e.device_time_total / 1e3 / iters)
        return out

    def cache(B, KV, T, d, dt):
        return torch.randn(B, T, KV, d, generator=gen, device=dev,
                           dtype=dtypes[dt]).transpose(1, 2)

    def emit(**row):
        print(json.dumps({"root": root, **row}), flush=True)

    for dt in dtypes:
        for (name, B, KV, G, d, T, L) in SHAPES:
            q = torch.randn(B, KV, G, d, generator=gen, device=dev,
                            dtype=dtypes[dt])
            k, v = cache(B, KV, T, d, dt), cache(B, KV, T, d, dt)

            def call():
                return ops.decode_attention(q, k, v, L)

            emit(dtype=dt, shape=name, ms=event_ms(call),
                 device_ms_by_kernel=device_ms(call))
            del q, k, v
            torch.cuda.empty_cache()
    for dt in dtypes:
        q = torch.randn(4, 2, 7, 64, generator=gen, device=dev,
                        dtype=dtypes[dt])
        k = cache(4, 2, 144, 64, dt)
        for _ in range(50):
            ops.decode_attention(q, k, k, 143)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            ops.decode_attention(q, k, k, 143)
        host_us = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
        emit(dtype=dt, shape="serve", host_us_per_call=host_us)
    if plans and hasattr(ops, "split_plan"):
        for dt in dtypes:
            q = torch.randn(1, 2, 7, 64, generator=gen, device=dev,
                            dtype=dtypes[dt])
            k, v = cache(1, 2, 524288, 64, dt), cache(1, 2, 524288, 64, dt)

            def call():
                return ops.decode_attention(q, k, v, 524288)

            call()
            key = (dt, 64, 7, 0)
            slots = ops._SLOTS[key]
            try:
                for waves in (1, 2, 3, 4):
                    ops._SLOTS[key] = waves * slots
                    emit(dtype=dt, shape="long_500k", waves=waves,
                         plan=ops.split_plan(q, 524288), ms=event_ms(call),
                         device_ms_by_kernel=device_ms(call))
            finally:
                ops._SLOTS[key] = slots
            del q, k, v
            torch.cuda.empty_cache()


def main(argv) -> int:
    plans = "--plans" in argv
    roots = [a for a in argv if a != "--plans"]
    if len(roots) == 2 and roots[0] == "--root":      # one child process
        run_one(roots[1], plans)
        return 0
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for root in roots:
        cmd = [sys.executable, os.path.abspath(__file__), "--root", root]
        if plans:
            cmd.append("--plans")
        rc = subprocess.run(cmd).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
