"""The plain PyTorch version of flash attention: dense softmax attention with
GQA, as ``flash_attention_ref`` of the reference
(``src/repro/kernels/flash_attention/ref.py``).

It materialises the (B, H, S, T) f32 score matrix; the kernel exists so the
LM forward does not.  CPU tensors take it through ``ops.flash_attention``,
and ``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, t_valid: Optional[int] = None
                        ) -> torch.Tensor:
    """q (B, H, S, d); k, v (B, KV, T, d) -> (B, H, S, d) in q's dtype.

    Query head h reads KV head ``h // (H / KV)``; f32 scores scaled by
    1/sqrt(d); keys at ``kpos >= t_valid`` and, when ``causal``, at
    ``kpos > qpos`` (top-left aligned) get -1e30; softmax in f32."""
    S, d = q.shape[2], q.shape[3]
    T = k.shape[2]
    group = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kk) / (d ** 0.5)
    tpos = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if t_valid is not None:
        mask &= tpos[None, :] < t_valid
    if causal:
        mask &= tpos[None, :] <= torch.arange(S, device=q.device)[:, None]
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, vv).to(q.dtype)
