"""The plain PyTorch version of decode attention: one query token per
sequence against a KV cache with a valid prefix, as ``decode_attention_ref``
of the reference (``src/repro/kernels/decode_attention/ref.py``).

It reads the whole cache capacity and materialises the (B, KV, G, T) f32
scores; the kernel reads only the valid prefix.  CPU tensors take it through
``ops.decode_attention``, and ``chip_smoke.py`` holds the kernel against it
on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(length: int, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """q (B, KV, G, d); k, v (B, KV, T, d) -> (B, KV, G, d) in q's dtype.

    f32 scores scaled by 1/sqrt(d); keys at ``t >= length`` get -1e30;
    softmax in f32, then an f32 product with v."""
    d, T = q.shape[-1], k.shape[2]
    s = torch.einsum("bhgd,bhtd->bhgt", q.float(), k.float()) / (d ** 0.5)
    valid = torch.arange(T, device=q.device) < length
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgt,bhtd->bhgd", p, v.float()).to(q.dtype)
