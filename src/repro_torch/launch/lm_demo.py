"""Batched LM generation demo (prefill + greedy decode with KV caches), the
port of ``repro/launch/lm_demo.py``.

Runs an LM config's smoke size on one device: prefills the caches with the
prompts, then decodes greedily.  ``serve_batch`` runs at any size.  Prefill
takes the chunked attention path, as in the reference; with
``attn_impl="cuda"`` each decode step runs the decode-attention kernel once
per layer (24 launches per step for qwen2-0.5b, 24 x (gen - 1) per
``serve_batch`` call) and the flash-attention kernel never.  MoE configs
(arctic-480b) route each layer's MLP through their experts; MLA
(deepseek-v2-lite-16b) attends to its compressed cache with plain products
and launches no attention kernel.

This is a transformer-stack demo, not the retrieval serving tier.

    python -m repro_torch.launch.lm_demo --arch qwen2-0.5b --batch 4 \\
        --prompt-len 16 --gen 24 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.models import transformer as tfm

#: the registry's LM architectures
LM_ARCHS = ("deepseek-67b", "qwen2-0.5b", "qwen2-72b", "arctic-480b",
            "deepseek-v2-lite-16b")


def serve_batch(params, cfg, prompts: torch.Tensor, gen: int
                ) -> torch.Tensor:
    """prompts (B, P) int32 -> generated (B, gen) int32 (greedy)."""
    B, P = prompts.shape
    with torch.inference_mode():
        logits, caches = tfm.prefill(params, cfg, prompts, max_len=P + gen)
        tok = logits[:, -1].argmax(-1).reshape(B, 1).to(torch.int32)
        out = [tok]
        for i in range(gen - 1):
            logits, caches = tfm.decode_step(params, cfg, caches, tok, P + i)
            tok = logits[:, 0].argmax(-1).reshape(B, 1).to(torch.int32)
            out.append(tok)
        return torch.cat(out, dim=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=LM_ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) but no CUDA device "
                           "is visible; pass --device cpu to run on the CPU")

    cfg = registry.get(args.arch).smoke_config()
    params = tfm.params_from_numpy(tfm.init_numpy(cfg, args.seed),
                                   args.device)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (args.batch, args.prompt_len))
        .astype(np.int32)).to(args.device)

    t0 = time.perf_counter()
    gen = serve_batch(params, cfg, prompts, args.gen)
    if args.device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = args.batch * args.gen
    print(f"[lm_demo] arch={args.arch} device={args.device} "
          f"batch={args.batch} prompt={args.prompt_len} gen={args.gen}: "
          f"{toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s)")
    print("sample:", gen[0, :16].cpu().numpy())


if __name__ == "__main__":
    main()
