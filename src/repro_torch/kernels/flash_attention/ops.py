"""Wrapper of the flash-attention CUDA kernels (``csrc/flash_attention.cu``).

The kernels replace the Pallas TPU kernel of the reference
(``src/repro/kernels/flash_attention/kernel.py``: ``flash_attention_kernel``,
body ``_flash_kernel``).  At the LM path's shape both are bound by
operations.  bf16 runs on tensor cores (``wgmma``) fed by TMA loads: q . k,
and p . v with p split into two bf16 halves (``p_hi + p_lo``) so that p
keeps f32 precision, as in the TPU body; f32 runs as FMA on the CUDA cores.
The source says why and how.

The bf16 kernel reads q, k and v through 4-D TMA tensor maps (d, seq, head,
batch) over their own strides; :func:`tensor_map_geometry`
(:mod:`repro_torch.kernels.tma`, shared with the decode kernel) computes
each map's dims, byte strides, box and swizzle, and raises on what TMA
refuses (a base that is not 16-byte aligned, a stride that is not a
multiple of 16 bytes).

Dispatch is by the device of the tensors and nothing else: tensors on the
CPU take the plain version of :mod:`.ref`; tensors on a CUDA device launch
the kernel, or raise on what the kernel does not take.  There is no
fallback from one to the other.  The checks below hold on both devices.

The reference kernel has no backward (``jax.grad`` through it fails), so
neither has this one: inputs that require grad raise.

``launches`` counts kernel launches per dtype (``f32``, ``bf16``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.tma import TensorMap, tensor_map_geometry

__all__ = ["BLOCK_Q", "HEAD_DIMS", "TensorMap", "block_keys",
           "flash_attention", "launches", "reset_launches",
           "tensor_map_geometry"]

#: head dims with a kernel instantiation: those the reference's kernel tests
#: use, and 8 (the qwen2-0.5b smoke config)
HEAD_DIMS = (8, 16, 32, 64, 128)

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

launches: Dict[str, int] = {"f32": 0, "bf16": 0}

#: query rows per block of the bf16 kernel
BLOCK_Q = 128
#: the bf16 entry point's code when cuTensorMapEncodeTiled is not found
_NO_ENCODER = -999

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGS = {"f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
         "bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                  _P]}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


#: the kernel's library: name -> sources under ``csrc/``
LIBRARY = {"flash_attention": ["flash_attention.cu"]}


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load_libraries
    lib = load_libraries(LIBRARY)["flash_attention"]
    if not getattr(lib, "_repro_typed", False):
        for dt, args in _ARGS.items():
            fn = getattr(lib, f"flash_attention_{dt}")
            fn.argtypes = args
            fn.restype = _I
        lib._repro_typed = True
    return lib


def block_keys(d: int) -> int:
    """Keys per K/V tile of the bf16 kernel at head dim ``d``: 64 at d=128
    keeps its accumulators in registers, 128 elsewhere."""
    return 64 if d > 64 else 128


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           t_valid: Optional[int]) -> int:
    """Raise on what the kernel does not take; return ``t_valid``."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, H, S, d) and k, v (B, KV, T, d); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v have dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; the kernel takes all f32 or all bf16")
    B, H, _, d = q.shape
    if k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim")
    KV, T = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads do not divide into {KV} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} has no kernel (takes {HEAD_DIMS})")
    t_valid = T if t_valid is None else int(t_valid)
    if not 1 <= t_valid <= T:
        # with no valid key the reference kernel's answer depends on its
        # block size; no caller passes such a t_valid
        raise ValueError(f"t_valid={t_valid} outside [1, T={T}]")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("flash_attention has no backward; call it on "
                           "tensors that do not require grad")
    return t_valid


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, t_valid: Optional[int] = None
                    ) -> torch.Tensor:
    """Attention with online softmax: q (B, H, S, d), k, v (B, KV, T, d)
    -> (B, H, S, d) in q's dtype, with q's strides on the card.

    GQA (query head h reads KV head ``h // (H / KV)``), scale 1/sqrt(d),
    keys at ``kpos >= t_valid`` masked (``t_valid`` in [1, T], default T)
    and, when ``causal``, keys at ``kpos > qpos`` (top-left aligned).  On
    the card the inputs may be strided views whose last dim is contiguous,
    such as ``x.transpose(1, 2)`` of a (B, S, H, d) tensor."""
    t_valid = _check(q, k, v, t_valid)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, t_valid=t_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous, got "
                             f"strides {t.stride()}")
    out = torch.empty_like(q)
    B, H, S, d = q.shape
    if out.numel() == 0:
        return out
    dt = _DTYPES[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if dt == "f32":
        strides = (ctypes.c_longlong * 12)(
            *(t.stride(i) for t in (q, k, v, out) for i in range(3)))
        rc = _lib().flash_attention_f32(
            *ptrs, ctypes.cast(strides, _P), B, H, k.shape[1], S,
            k.shape[2], d, t_valid, int(causal), 1.0 / d ** 0.5, stream)
    else:
        geo = [x for t, rows in ((q, BLOCK_Q), (k, block_keys(d)),
                                 (v, block_keys(d)))
               for x in tensor_map_geometry(t, rows).flat()]
        o_strides = (ctypes.c_longlong * 3)(*out.stride()[:3])
        geo = (ctypes.c_longlong * len(geo))(*geo)
        rc = _lib().flash_attention_bf16(
            *ptrs, ctypes.cast(o_strides, _P), ctypes.cast(geo, _P), B, H,
            k.shape[1], S, d, t_valid, int(causal), 1.0 / d ** 0.5, stream)
    if rc == _NO_ENCODER:
        raise RuntimeError("flash_attention_bf16: cuTensorMapEncodeTiled "
                           "not found")
    if rc < 0:
        raise RuntimeError(f"flash_attention_bf16: cuTensorMapEncodeTiled "
                           f"refused a tensor map (CUresult {-rc})")
    if rc != 0:
        raise RuntimeError(f"flash_attention_{dt} launch failed with CUDA "
                           f"error {rc}")
    launches[dt] += 1
    return out
