"""Plain PyTorch bi-encoders: the math the trunks share, and
:func:`encode`, which runs the trunk of the configuration's type
(``bench/models/<model_type>.py``) and pools.

The trunks follow their published equations with the departures that the
configuration file lists under ``departures``.  Everything runs in
float32 with TF32 off; ``precision="fp8"`` rounds both operands of every
weight product to float8 e4m3 first (per-row scales for the activations,
per-column scales for the weights), which is the control.  The weights
are the flat ``{key path: tensor}`` dict of :func:`bench.weights.draw`,
read in the port's checkpoint layout; a trunk widens a layer's leaves to
float32 when it reaches that layer, so a bf16 tree never has a float32
copy of itself beside it.

Sequences are encoded at their own lengths: sorted by length and batched
with the batch's longest, so no sequence is padded to the maximum.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from bench import models

F8_MAX = 448.0


def exact_matmul() -> None:
    """True float32 products: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / F8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _widen(leaf: torch.Tensor, precision: str) -> torch.Tensor:
    """One layer's weight of a product as the product reads it: float32,
    and for the control rounded to fp8 with a scale per output column."""
    w = leaf.float()
    return _fp8(w, -2) if precision == "fp8" else w


def _mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    return (_fp8(x, -1) if precision == "fp8" else x) @ w


def _layernorm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale.float() + bias.float()


def _rmsnorm(x, scale, eps):
    return x / torch.sqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def _attention(q, k, v, valid, causal):
    """q (B, n, H, hd), k / v (B, n, KV, hd), valid (B, n) -> (B, n, H*hd)."""
    B, n, H, hd = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)       # head h reads KV head h // rep
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    allowed = valid[:, None, None, :]
    if causal:
        pos = torch.arange(n, device=q.device)
        allowed = allowed & (pos[None, :] <= pos[:, None])[None, None]
    s = s.masked_fill(~allowed, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, n, H * hd)


def _rope(x, theta):
    """Rotary embedding, dimension d paired with d + hd/2."""
    n, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd)
    ang = (torch.arange(n, dtype=torch.float64)[:, None] * inv[None, :])
    cos = torch.cos(ang).float().to(x.device)[None, :, None, :]
    sin = torch.sin(ang).float().to(x.device)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


@torch.inference_mode()
def encode(cfg: dict, W: Dict[str, torch.Tensor],
           texts: Sequence[Sequence[int]], max_len: int, *,
           precision: str = "f32", batch_tokens: int = 1 << 15
           ) -> torch.Tensor:
    """(N, D) float32 unit embeddings of ``texts`` (each cut to
    ``max_len`` tokens) on the weights' device, in ``texts`` order."""
    if precision not in ("f32", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")
    device = W["embed/table"].device
    pooling = cfg["retriever"]["pooling"]
    trunk = models.of(cfg).trunk
    lens = [max(1, min(len(t), max_len)) for t in texts]
    order = sorted(range(len(texts)), key=lambda i: lens[i])
    out = torch.empty(len(texts), cfg["hidden_size"], device=device)
    at = 0
    while at < len(order):
        # the batch's longest text sets its width; grow while it fits
        end = at + 1
        while end < len(order) and \
                (end + 1 - at) * lens[order[end]] <= batch_tokens:
            end += 1
        idx = order[at:end]
        n = lens[idx[-1]]
        tok = torch.zeros(len(idx), n, dtype=torch.long)
        valid = torch.zeros(len(idx), n, dtype=torch.bool)
        for r, i in enumerate(idx):
            t = list(texts[i])[:n]
            tok[r, :len(t)] = torch.tensor(t, dtype=torch.long)
            valid[r, :len(t)] = True
        tok, valid = tok.to(device), valid.to(device)
        h = trunk(cfg, W, tok, valid, precision)
        if pooling == "cls":
            e = h[:, 0]
        else:
            mk = valid[..., None].float()
            e = (h * mk).sum(1) / mk.sum(1)
        e = e / e.norm(dim=-1, keepdim=True)
        out[torch.tensor(idx, device=device)] = e
        at = end
    return out

