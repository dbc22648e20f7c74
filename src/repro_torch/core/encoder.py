"""Batch encoding of pre-tokenized texts (``repro/core/encoder.py``)."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Sequence

import numpy as np
import torch

from repro_torch.data.corpus import Tokens, pad_batch


@dataclasses.dataclass
class EncodeStats:
    n_texts: int
    n_batches: int
    wall_time_s: float


@torch.inference_mode()
def encode_texts(encode_fn: Callable, params, texts: Sequence[Tokens], *,
                 max_len: int, batch_size: int,
                 device="cuda") -> tuple[np.ndarray, EncodeStats]:
    """Encode a list of token sequences -> ((N, D) f32 numpy, stats).

    ``encode_fn(params, tokens (B, L) int32, mask (B, L) bool) -> (B, D)``
    runs on ``device`` (the GPU unless the caller asks for the CPU).  The
    final ragged batch is padded to ``batch_size`` (and the padding rows
    dropped), so every call sees one shape."""
    t0 = time.time()
    out: List[np.ndarray] = []
    n_batches = 0
    for start in range(0, len(texts), batch_size):
        chunk = list(texts[start:start + batch_size])
        real = len(chunk)
        chunk = chunk + [[0]] * (batch_size - real)
        toks, mask = pad_batch(chunk, max_len)
        emb = encode_fn(params, torch.from_numpy(toks).to(device),
                        torch.from_numpy(mask).to(device))
        out.append(emb[:real].float().cpu().numpy())
        n_batches += 1
    embs = (np.concatenate(out, axis=0) if out
            else np.zeros((0, 1), np.float32))
    return embs, EncodeStats(n_texts=len(texts), n_batches=n_batches,
                             wall_time_s=time.time() - t0)
