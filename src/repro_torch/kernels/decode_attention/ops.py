"""Wrapper of the decode-attention CUDA kernel (``csrc/decode_attention.cu``).

The kernel replaces the Pallas TPU kernel of the reference
(``src/repro/kernels/decode_attention/kernel.py``:
``decode_attention_kernel``, body ``_decode_kernel``).  It is bound by the
bytes of the valid K and V prefix.  A producer warp streams K and V tiles
through a TMA ring; bf16 runs q . k and p . v (p split into two bf16
halves) as ``mma.sync`` on tensor cores, f32 as FMA; the prefix is cut into
about one wave of long splits (:func:`plan_splits`), merged by a second
pass when there is more than one.  The source says why and how.

K and V are read through 4-D TMA tensor maps over their own strides
(:func:`repro_torch.kernels.tma.tensor_map_geometry`); the geometry is kept
per (address, shape, strides) here and the encoded maps in the library, so
a step of the LM trunk, which passes the same cache tensors every time,
encodes nothing.

Dispatch is by the device of the tensors and nothing else: tensors on the
CPU take the plain version of :mod:`.ref`; tensors on a CUDA device launch
the kernel, or raise on what the kernel does not take.  There is no
fallback from one to the other.  The checks of :func:`_check` hold on both
devices.

Unlike the reference wrapper, this one pads neither G to 8 nor d to 128 and
does not rescale q in q's dtype: the kernel scales in f32.  The reference
kernel has no backward, so inputs that require grad raise.

``launches`` counts calls that launched the kernel (both passes count once)
per dtype (``f32``, ``bf16``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple, Union

import torch

from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.tma import tensor_map_geometry

__all__ = ["HEAD_DIMS", "MAX_GROUP", "block_keys", "decode_attention",
           "launches", "plan_splits", "reset_launches", "split_plan"]

#: head dims with a kernel instantiation, as the flash-attention kernel's
HEAD_DIMS = (8, 16, 32, 64, 128)
#: most query rows per KV head (G = H / KV) the kernel keeps on chip
MAX_GROUP = 16
#: least keys of a split where the prefix has them: two tiles for each of
#: a block's consumer warps
MIN_CHUNK = 512
#: waves of resident blocks that the plan aims at: long splits keep each
#: block's ring fill and merge small beside its stream of K and V
WAVES = 1

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

launches: Dict[str, int] = {"f32": 0, "bf16": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
         _P, _P]
#: the library's code when cuTensorMapEncodeTiled is not found
_NO_ENCODER = -999
#: (dtype, head dim, G, device index) -> blocks of pass 1 the device holds
_SLOTS: Dict[Tuple[str, int, int, int], int] = {}
#: (k, v addresses, shape, strides, dtype) -> the maps' geometry as the
#: library takes it; the trunk's cache tensors are the same at every step
_GEO: Dict[tuple, ctypes.Array] = {}
_GEO_MAX = 256


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


#: the kernel's library: name -> sources under ``csrc/``
LIBRARY = {"decode_attention": ["decode_attention.cu"]}


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load_libraries
    lib = load_libraries(LIBRARY)["decode_attention"]
    if not getattr(lib, "_repro_typed", False):
        for fn in (lib.decode_attention_f32, lib.decode_attention_bf16):
            fn.argtypes = _ARGS
            fn.restype = _I
        for fn in (lib.decode_attention_slots_f32,
                   lib.decode_attention_slots_bf16):
            fn.argtypes = [_I, _I, ctypes.POINTER(_I)]
            fn.restype = _I
        lib._repro_typed = True
    return lib


def block_keys(dt: str, d: int) -> int:
    """Keys per K/V tile (the TMA box's rows) of the kernel for dtype ``dt``
    and head dim ``d``: 64 at bf16 up to d = 64, else 32 (lane j of an f32
    warp scores key j)."""
    return 64 if dt == "bf16" and d <= 64 else 32


def plan_splits(length: int, bkv: int, slots: int,
                keys: int = 64) -> Tuple[int, int]:
    """Cut the valid prefix [0, length) into ``n`` splits of ``chunk`` keys
    (a multiple of ``keys``, the kernel's tile; the last split may be
    shorter, none is empty) so that the ``bkv * n`` blocks fill about
    ``WAVES`` waves of the device's ``slots`` and no more (or ``bkv``
    blocks, one split each, when ``bkv`` alone exceeds them), with chunks of
    at least ``MIN_CHUNK`` keys where the prefix has them.  Returns
    (n, chunk)."""
    want = max(1, WAVES * slots // bkv)
    n = max(1, min(want, length // MIN_CHUNK))
    chunk = -(-(-(-length // n)) // keys) * keys
    n = -(-length // chunk)
    assert (n - 1) * chunk < length <= n * chunk, (length, n, chunk)
    return n, chunk


def _length(length: Union[int, torch.Tensor]) -> int:
    if isinstance(length, torch.Tensor):
        if length.numel() != 1 or length.dtype.is_floating_point \
                or length.dtype == torch.bool:
            raise TypeError(f"length must be an int or a one-element "
                            f"integer tensor, got {length.dtype} "
                            f"{tuple(length.shape)}")
        return int(length.reshape(()).item())
    return int(length)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           length: Union[int, torch.Tensor]) -> int:
    """Raise on what the kernel does not take; return ``length`` as int."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, KV, G, d) and k, v (B, KV, T, d); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v have dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; the kernel takes all f32 or all bf16")
    B, KV, G, d = q.shape
    if k.shape[0] != B or k.shape[1] != KV or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch, KV heads or head dim")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} has no kernel (takes {HEAD_DIMS})")
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"{G} query rows per KV head; the kernel takes 1 "
                         f"to {MAX_GROUP}")
    length, T = _length(length), k.shape[2]
    if not 1 <= length <= T:
        # at length 0 the reference kernel returns 0 and its plain version
        # the mean of v: there is no contract to copy, and no caller
        raise ValueError(f"length={length} outside [1, T={T}]")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("decode_attention has no backward; call it on "
                           "tensors that do not require grad")
    return length


def _check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The kernel reads q's rows contiguously; K and V go through TMA maps,
    whose geometry raises on what TMA refuses."""
    if q.stride(3) != 1:
        raise ValueError(f"q's last dim must be contiguous, got strides "
                         f"{q.stride()}")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError(f"B * KV = {q.shape[0] * q.shape[1]} exceeds the "
                         "grid's 65535")


def _geometry(k: torch.Tensor, v: torch.Tensor, rows: int) -> ctypes.Array:
    """The tensor maps' geometry of k and v (12 values each) in boxes of
    ``rows`` keys, kept per (addresses, shape, strides, dtype)."""
    key = (k.data_ptr(), v.data_ptr(), k.shape, k.stride(), v.stride(),
           k.dtype, rows)
    geo = _GEO.get(key)
    if geo is None:
        flat = (*tensor_map_geometry(k, rows).flat(),
                *tensor_map_geometry(v, rows).flat())
        if len(_GEO) >= _GEO_MAX:
            _GEO.clear()
        geo = _GEO[key] = (ctypes.c_longlong * 24)(*flat)
    return geo


def _slots(lib: ctypes.CDLL, dt: str, d: int, G: int,
           device: torch.device) -> int:
    key = (dt, d, G, device.index or 0)
    if key not in _SLOTS:
        out = _I(0)
        fn = getattr(lib, f"decode_attention_slots_{dt}")
        with torch.cuda.device(device):
            rc = fn(d, G, ctypes.byref(out))
        if rc != 0 or out.value < 1:
            raise RuntimeError(f"decode_attention_{dt}: occupancy query "
                               f"failed with CUDA error {rc}")
        _SLOTS[key] = out.value
    return _SLOTS[key]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: Union[int, torch.Tensor]) -> torch.Tensor:
    """One query token per sequence against a KV cache: q (B, KV, G, d),
    k, v (B, KV, T, d) -> (B, KV, G, d) in q's dtype.

    Query row g of KV head h attends to keys ``t < length`` of head h
    (``length`` in [1, T], an int or a one-element integer tensor), scale
    1/sqrt(d).  On the card k and v may be strided views whose last dim is
    contiguous and whose rows start on 16-byte boundaries, such as
    ``cache.transpose(1, 2)`` of a (B, T, KV, d) cache; the kernel reads only
    the keys before ``length``, on the current stream."""
    length = _check(q, k, v, length)
    if q.device.type == "cpu":
        return decode_attention_ref(length, q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check_layout(q, k, v)
    B, KV, G, d = q.shape
    out = torch.empty((B, KV, G, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    dt = _DTYPES[q.dtype]
    lib = _lib()
    geo = _geometry(k, v, block_keys(dt, d))
    n_splits, chunk = _plan(lib, q, length)
    scratch = None
    if n_splits > 1:
        scratch = torch.empty(B * KV * n_splits * G * (d + 2),
                              dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    fn = getattr(lib, f"decode_attention_{dt}")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, geo, B, KV, G, d, length, n_splits, chunk,
            1.0 / d ** 0.5, 0 if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc == _NO_ENCODER:
        raise RuntimeError(f"decode_attention_{dt}: cuTensorMapEncodeTiled "
                           "not found")
    if rc < 0:
        raise RuntimeError(f"decode_attention_{dt}: cuTensorMapEncodeTiled "
                           f"refused a tensor map (CUresult {-rc})")
    if rc != 0:
        raise RuntimeError(f"decode_attention_{dt} launch failed with CUDA "
                           f"error {rc}")
    launches[dt] += 1
    return out


def _plan(lib: ctypes.CDLL, q: torch.Tensor, length: int) -> Tuple[int, int]:
    B, KV, G, d = q.shape
    dt = _DTYPES[q.dtype]
    return plan_splits(length, B * KV, _slots(lib, dt, d, G, q.device),
                       block_keys(dt, d))


def split_plan(q: torch.Tensor, length: int) -> Tuple[int, int]:
    """(splits, keys per split) that :func:`decode_attention` plans for a
    CUDA tensor ``q`` (B, KV, G, d) and ``length`` valid keys."""
    return _plan(_lib(), q, length)
