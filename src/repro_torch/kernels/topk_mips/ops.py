"""Wrapper of the topk_mips CUDA kernels (``csrc/topk_mips.cu``).

The kernels replace the Pallas TPU kernels of the reference
(``src/repro/kernels/topk_mips/kernel.py``: ``topk_mips_kernel`` at f32 and
bf16, ``topk_mips_kernel_int8`` at int8).  At the engine's shape they are
bound by arithmetic at f32 (no TF32 is allowed, so the tensor cores are
out) and by memory at bf16 and int8; the source says how the design
replaces the TPU's sequential running top-k with a split-and-merge in two
passes.

Dispatch is by the device of the tensors and nothing else: a tensor on the
CPU takes the plain version of :mod:`.ref`; a tensor on a CUDA device
launches the kernel, or raises on what the kernel does not take.  There is
no fallback from one to the other.

``launches`` counts kernel launches per variant (``f32``, ``bf16``,
``int8``): one for each call into the library, which runs both passes.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.topk_mips.ref import (SCORE_DTYPES, merge_carry_ref,
                                               quantize_int8, topk_mips_ref)

__all__ = ["SCORE_DTYPES", "MAX_K", "quantize_int8", "topk_mips",
           "topk_mips_chunk", "launches", "reset_launches"]

#: largest k the kernels take (bounded by pass 2's shared-memory sort)
MAX_K = 4096

launches: Dict[str, int] = {"f32": 0, "bf16": 0, "int8": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_FLOAT_ARGS = [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I,
               _P, _P, _P, _P, _P]
_INT8_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I,
              _P, _P, _P, _P, _P]


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


#: the kernel's library: name -> sources under ``csrc/``
LIBRARY = {"topk_mips": ["topk_mips.cu"]}


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load_libraries
    lib = load_libraries(LIBRARY)["topk_mips"]
    if not getattr(lib, "_repro_typed", False):
        lib.topk_mips_f32.argtypes = _FLOAT_ARGS
        lib.topk_mips_bf16.argtypes = _FLOAT_ARGS
        lib.topk_mips_int8.argtypes = _INT8_ARGS
        for fn in (lib.topk_mips_f32, lib.topk_mips_bf16, lib.topk_mips_int8,
                   lib.topk_mips_block_cols, lib.topk_mips_max_candidates):
            fn.restype = _I
        lib.topk_mips_block_cols.argtypes = []
        lib.topk_mips_max_candidates.argtypes = []
        lib._repro_typed = True
    return lib


def _check(t: torch.Tensor, name: str, dtypes, device, ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes "
                        f"{' or '.join(map(str, dtypes))}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _kernel_inputs(q, c, score_dtype):
    """Cast or quantize the operands as the variant needs them."""
    dtypes = (torch.float32, torch.bfloat16) if score_dtype == "bf16" \
        else (torch.float32,)
    _check(q, "q", dtypes, q.device, 2)
    _check(c, "c", dtypes, q.device, 2)
    if q.shape[1] != c.shape[1]:
        raise ValueError(f"feature dims differ: q {tuple(q.shape)}, "
                         f"c {tuple(c.shape)}")
    if score_dtype == "f32":
        return q, c, None, None
    if score_dtype == "bf16":
        return q.to(torch.bfloat16), c.to(torch.bfloat16), None, None
    qv, qs = quantize_int8(q)
    cv, cs = quantize_int8(c)
    return qv, cv, qs.reshape(-1).contiguous(), cs.reshape(-1).contiguous()


def _windows(n_rows: int, n_valid: int, k_target: int, kc: int, cn: int,
             max_cand: int):
    """Cut the corpus into launches: ``[(w0, width, nv, kc, k_out), ...]``.

    A window of ``width`` rows yields ``ceil(width / cn)`` partial lists of
    ``min(k_target, cn)`` entries each; with the ``kc`` carry entries they
    must fit pass 2's ``max_cand`` candidates.  Each window folds into the
    carry the previous one left (``kc``), keeping the reference's order:
    earlier rows win ties.  Rows at or past ``n_valid`` are never scored."""
    kk = min(k_target, cn)
    out, w0 = [], 0
    while w0 < n_valid:
        width = min(n_rows - w0, cn * ((max_cand - kc) // kk))
        nv = min(n_valid - w0, width)
        k_out = min(k_target, kc + nv)
        out.append((w0, width, nv, kc, k_out))
        kc, w0 = k_out, w0 + width
    return out


def _topk_cuda(score_dtype: str, q, c, q_scale, c_scale, *, k_target: int,
               n_valid: int, carry=None, base: int = 0):
    """Top ``k_target`` of ``carry || c[:n_valid]`` per query row, one
    launch per window of :func:`_windows`."""
    lib = _lib()
    cn = lib.topk_mips_block_cols()
    Q, D = q.shape
    fn = {"f32": lib.topk_mips_f32, "bf16": lib.topk_mips_bf16,
          "int8": lib.topk_mips_int8}[score_dtype]
    run_s, run_i = carry if carry is not None else (None, None)
    kk = min(k_target, cn)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    for w0, width, nv, kc, k_out in _windows(
            c.shape[0], n_valid, k_target, 0 if run_s is None else
            run_s.shape[1], cn, lib.topk_mips_max_candidates()):
        n_splits = -(-width // cn)
        part_s = torch.empty((Q, n_splits, kk), dtype=torch.float32,
                             device=q.device)
        part_i = torch.empty((Q, n_splits, kk), dtype=torch.int32,
                             device=q.device)
        out_s = torch.empty((Q, k_out), dtype=torch.float32, device=q.device)
        out_i = torch.empty((Q, k_out), dtype=torch.int32, device=q.device)
        head = [_ptr(q), _ptr(c[w0:w0 + width])]
        if score_dtype == "int8":
            head += [_ptr(q_scale), _ptr(c_scale[w0:w0 + width])]
        rc = fn(*head, Q, width, D, nv, kk, _ptr(run_s), _ptr(run_i), kc,
                base + w0, k_out, _ptr(part_s), _ptr(part_i), _ptr(out_s),
                _ptr(out_i), stream)
        if rc != 0:
            raise RuntimeError(f"topk_mips_{score_dtype} launch failed with "
                               f"CUDA error {rc}")
        launches[score_dtype] += 1
        run_s, run_i = out_s, out_i
    return run_s, run_i


def _validate(score_dtype: str, k: int) -> None:
    if score_dtype not in SCORE_DTYPES:
        raise ValueError(f"unknown score_dtype {score_dtype!r} "
                         f"(expected one of {SCORE_DTYPES})")
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the kernels' maximum of {MAX_K}")


def topk_mips(q: torch.Tensor, c: torch.Tensor, *, k: int,
              n_valid: Optional[int] = None, score_dtype: str = "f32"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k MIPS: q (Q, D) x c (N, D) -> (scores (Q, k_eff) f32,
    indices (Q, k_eff) i32), ``k_eff = min(k, n_valid)``.

    ``n_valid`` marks how many leading corpus rows are real (default all);
    later rows are never returned.  ``score_dtype`` is ``"f32"``, ``"bf16"``
    (inputs rounded to bf16, f32 products and sums) or ``"int8"`` (per-row
    quantization, exact integer sums, per-row scales folded in before the
    selection)."""
    _validate(score_dtype, k)
    N = c.shape[0]
    n_valid = N if n_valid is None else max(0, min(n_valid, N))
    if q.device.type == "cpu":
        return topk_mips_ref(q, c, k=k, n_valid=n_valid,
                             score_dtype=score_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"topk_mips runs on cpu or cuda, not {q.device}")
    k_eff = min(k, n_valid)
    if k_eff <= 0 or q.shape[0] == 0:          # nothing to launch
        shape = (q.shape[0], max(k_eff, 0))
        return (torch.empty(shape, device=q.device),
                torch.empty(shape, dtype=torch.int32, device=q.device))
    qk, ck, qs, cs = _kernel_inputs(q, c, score_dtype)
    return _topk_cuda(score_dtype, qk, ck, qs, cs, k_target=k_eff,
                      n_valid=n_valid)


def topk_mips_chunk(q: torch.Tensor, c_chunk: torch.Tensor,
                    run_s: torch.Tensor, run_i: torch.Tensor, *, base: int,
                    n_valid: Optional[int] = None,
                    score_dtype: str = "f32"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-carry entry point of the streaming engine: fold the top-k of
    one corpus chunk (global row offset ``base``, first ``n_valid`` rows
    real) into the running ``(Q, k)`` carry and return the new carry.  On
    the card the carry is merged inside the kernel's second pass."""
    k = run_s.shape[1]
    _validate(score_dtype, k)
    N = c_chunk.shape[0]
    n = N if n_valid is None else min(n_valid, N)
    if n <= 0 or q.shape[0] == 0:
        return run_s, run_i
    if q.device.type == "cpu":
        s, i = topk_mips_ref(q, c_chunk, k=min(k, n), n_valid=n,
                             score_dtype=score_dtype)
        return merge_carry_ref(run_s, run_i, s, i, base, k)
    if q.device.type != "cuda":
        raise ValueError(f"topk_mips runs on cpu or cuda, not {q.device}")
    _check(run_s, "run_s", (torch.float32,), q.device, 2)
    _check(run_i, "run_i", (torch.int32,), q.device, 2)
    if run_s.shape != (q.shape[0], k) or run_i.shape != run_s.shape:
        raise ValueError(f"carry shapes {tuple(run_s.shape)}, "
                         f"{tuple(run_i.shape)} do not match ({q.shape[0]}, "
                         f"{k})")
    qk, ck, qs, cs = _kernel_inputs(q, c_chunk, score_dtype)
    return _topk_cuda(score_dtype, qk, ck, qs, cs, k_target=k, n_valid=n,
                      carry=(run_s, run_i), base=int(base))
