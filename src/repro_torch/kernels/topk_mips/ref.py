"""Plain PyTorch versions of the topk_mips kernels.

They are the kernels' arithmetic written as whole-tensor operations: the
CPU path of :mod:`repro_torch.kernels.topk_mips.ops` runs them, the tests
compare them with the JAX reference, and ``chip_smoke.py`` holds the CUDA
kernels against them on the card.

Precision contract (the same as the kernels'):
  * ``f32`` is true f32.  ``torch.backends.cuda.matmul.allow_tf32`` is set
    to False before the product, so a CUDA matmul keeps every mantissa bit.
  * ``bf16`` rounds the inputs to bf16 and then multiplies and sums in f32.
  * ``int8`` quantizes each row (:func:`quantize_int8`), forms the raw
    integer scores in float64, which is exact, and dequantizes as
    ``(float32(raw) * q_scale) * c_scale``.

Ordering follows ``lax.top_k``: scores descending, and on equal scores the
lower position wins.  ``torch.topk`` leaves tie order unspecified, so the
selection here is a stable descending sort.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

SCORE_DTYPES = ("f32", "bf16", "int8")


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization: ``x`` (..., D) -> (values int8,
    scales (..., 1) f32).  Scale is ``amax / 127`` in f32 and 1 for all-zero
    rows; values are ``x / scale`` rounded half to even (``torch.round``)
    and clipped to +-127 — the formula of the reference's
    ``kernels/topk_mips/ops.py::quantize_int8``."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    vals = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return vals, scale


def scores_ref(q: torch.Tensor, c: torch.Tensor,
               score_dtype: str = "f32") -> torch.Tensor:
    """Full score matrix (Q, N) f32 at one scoring precision."""
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 means f32
    if score_dtype == "f32":
        return q.float() @ c.float().T
    if score_dtype == "bf16":
        return q.to(torch.bfloat16).float() @ c.to(torch.bfloat16).float().T
    if score_dtype == "int8":
        qv, qs = quantize_int8(q)
        cv, cs = quantize_int8(c)
        return int8_scores_ref(qv, cv, qs.reshape(-1), cs.reshape(-1))
    raise ValueError(f"unknown score_dtype {score_dtype!r} "
                     f"(expected one of {SCORE_DTYPES})")


def int8_scores_ref(qv: torch.Tensor, cv: torch.Tensor, q_scale: torch.Tensor,
                    c_scale: torch.Tensor) -> torch.Tensor:
    """Dequantized scores of int8 images: exact raw integer products (formed
    in float64), then ``(raw * q_scale) * c_scale`` in f32."""
    raw = (qv.double() @ cv.double().T).float()
    return raw * q_scale.reshape(-1, 1) * c_scale.reshape(1, -1)


def select_topk(s: torch.Tensor, idx: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of each row of ``s`` with its ``idx``: descending, the
    earlier position first on equal scores."""
    order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(s, 1, order), torch.gather(idx, 1, order)


def topk_mips_ref(q: torch.Tensor, c: torch.Tensor, *, k: int,
                  n_valid: Optional[int] = None,
                  score_dtype: str = "f32"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (Q, D), c (N, D) -> (scores (Q, k_eff) f32, indices (Q, k_eff)
    i32), ``k_eff = min(k, n_valid)``; rows at or past ``n_valid`` are
    never returned."""
    N = c.shape[0]
    n_valid = N if n_valid is None else min(n_valid, N)
    s = scores_ref(q, c, score_dtype)[:, :n_valid]
    idx = torch.arange(n_valid, dtype=torch.int32,
                       device=s.device).expand(s.shape[0], -1)
    return select_topk(s, idx, min(k, n_valid))


def merge_carry_ref(run_s: torch.Tensor, run_i: torch.Tensor,
                    chunk_s: torch.Tensor, chunk_i: torch.Tensor, base: int,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a chunk-local top-k into the running (Q, k) carry: top ``k`` of
    ``[carry || chunk]``, so the carry wins ties."""
    s = torch.cat([run_s, chunk_s], dim=1)
    i = torch.cat([run_i, chunk_i.to(torch.int32) + base], dim=1)
    return select_topk(s, i, k)
