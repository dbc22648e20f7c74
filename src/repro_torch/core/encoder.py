"""Batch encoding of pre-tokenized texts (``repro/core/encoder.py``)."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.data.corpus import Tokens, pad_batch


@dataclasses.dataclass
class EncodeStats:
    n_texts: int
    n_batches: int
    wall_time_s: float


@torch.inference_mode()
def encode_tensor(encode_fn: Callable, params, texts: Sequence[Tokens], *,
                  max_len: int, batch_size: int,
                  device="cuda") -> tuple[torch.Tensor, int]:
    """Encode a list of token sequences -> ((N, D) f32 tensor on ``device``,
    number of batches).

    ``encode_fn(params, tokens (B, L) int32, mask (B, L) bool) -> (B, D)``
    runs on ``device`` (the GPU unless the caller asks for the CPU).  The
    final ragged batch is padded to ``batch_size`` (and the padding rows
    dropped), so every call sees one shape.  The embeddings stay on the
    device."""
    out: List[torch.Tensor] = []
    for start in range(0, len(texts), batch_size):
        chunk = list(texts[start:start + batch_size])
        real = len(chunk)
        chunk = chunk + [[0]] * (batch_size - real)
        toks, mask = pad_batch(chunk, max_len)
        emb = encode_fn(params, torch.from_numpy(toks).to(device),
                        torch.from_numpy(mask).to(device))
        out.append(emb[:real].float())
    if not out:
        return torch.zeros((0, 1), dtype=torch.float32, device=device), 0
    return torch.cat(out, dim=0), len(out)


def encode_texts(encode_fn: Callable, params, texts: Sequence[Tokens], *,
                 max_len: int, batch_size: int,
                 device="cuda") -> tuple[np.ndarray, EncodeStats]:
    """:func:`encode_tensor`, copied to the host -> ((N, D) f32 numpy,
    stats)."""
    t0 = time.time()
    embs, n_batches = encode_tensor(encode_fn, params, texts,
                                    max_len=max_len, batch_size=batch_size,
                                    device=device)
    embs = embs.cpu().numpy()
    return embs, EncodeStats(n_texts=len(texts), n_batches=n_batches,
                             wall_time_s=time.time() - t0)


def encode_corpus_dict(encode_fn, params, corpus: Dict[str, Tokens], *,
                       max_len: int, batch_size: int,
                       subset_ids: Optional[Sequence[str]] = None,
                       device="cuda"):
    """Encode (a subset of) a corpus dict -> (ids, embeddings, stats)."""
    ids = list(subset_ids) if subset_ids is not None else list(corpus)
    texts = [corpus[i] for i in ids]
    embs, stats = encode_texts(encode_fn, params, texts, max_len=max_len,
                               batch_size=batch_size, device=device)
    return ids, embs, stats
