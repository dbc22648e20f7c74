"""Wrapper of the topk_mips CUDA kernels (``csrc/topk_mips.cu``).

The kernels replace the Pallas TPU kernels of the reference
(``src/repro/kernels/topk_mips/kernel.py``: ``topk_mips_kernel`` at f32 and
bf16, ``topk_mips_kernel_int8`` at int8).  Each library call is two
launches: pass 1 scores (64 query rows) x (32 corpus rows) tiles (bf16 and
int8 on the tensor cores through ``wgmma``, f32 as a register-tiled FMA
product with no TF32, both fed by TMA) and keeps only the scores that can
still enter the top k (strictly above the carry's k-th score once the
carry is full); pass 2 radix-selects the k-th key of carry || survivors
per row and sorts only the k it keeps.  The source says why and how.

A :func:`topk_mips` call of few query rows over a corpus longer than one
window (a served micro-batch) takes the scan instead (:func:`_takes_scan`:
f32, no carry, at most ``SCAN_MAX_Q`` queries, ``k <= SCAN_MAX_K``, the
queries within the scan's shared memory): its pass 1 reads the corpus once
in one persistent launch and leaves one list per block, the same pass 2
merges them, and its scores are bit-equal to the tiled pass's.  Two
launches a call on either path.

The kernels need rows of a 16-byte multiple: :func:`padded_dim` gives the
feature width they take and :func:`pad_features` zero-pads to it (zeros
change no sum); D = 768 at every dtype needs no copy.  :func:`_windows`
cuts a corpus longer than pass 2's candidate budget into launches that fold
into the carry in order.

Dispatch is by the device of the tensors and nothing else: a tensor on the
CPU takes the plain version of :mod:`.ref`; a tensor on a CUDA device
launches the kernel, or raises on what the kernel does not take.  There is
no fallback from one to the other.

``launches`` counts kernel launches per variant (``f32``, ``bf16``,
``int8``): one for each call into the library, which runs both passes.
``scan_calls`` counts the f32 calls that took the scan (each also counts in
``launches["f32"]``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.topk_mips.ref import (SCORE_DTYPES, merge_carry_ref,
                                               quantize_int8, topk_mips_ref)

__all__ = ["SCORE_DTYPES", "MAX_K", "pad_features", "padded_dim",
           "quantize_int8", "topk_mips", "topk_mips_chunk", "launches",
           "reset_launches"]

#: largest k the kernels take (bounded by pass 2's shared-memory sort)
MAX_K = 4096

launches: Dict[str, int] = {"f32": 0, "bf16": 0, "int8": 0}
scan_calls = 0
# fleet workers on threads of one process launch concurrently
_LAUNCHES_LOCK = threading.Lock()

ELEM_BYTES = {"f32": 4, "bf16": 2, "int8": 1}
#: the library's code when cuTensorMapEncodeTiled is not found
_NO_ENCODER = -999

_P = ctypes.c_void_p
_I = ctypes.c_int
_FLOAT_ARGS = [_P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P]
_INT8_ARGS = [_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I,
              _P, _P, _P, _P, _P]
_SCAN_ARGS = [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]

#: the scan's limits, as in ``csrc/topk_mips.cu``: query rows, k, and the
#: shared memory of its queries (rows padded to a power of two, features
#: to a multiple of 32)
SCAN_MAX_Q, SCAN_MAX_K, SCAN_QUERY_BYTES = 16, 32, 48 * 1024


def reset_launches() -> None:
    global scan_calls
    for key in launches:
        launches[key] = 0
    scan_calls = 0


#: the kernel's library: name -> sources under ``csrc/``
LIBRARY = {"topk_mips": ["topk_mips.cu"]}

_LIB: Optional[ctypes.CDLL] = None


def _lib(device: torch.device) -> ctypes.CDLL:
    """The built library, typed, with its entry points by variant
    (``entry``), its geometry (``cols``: corpus rows per pass-1 tile,
    ``max_cand``: pass 2's keys per row) and the devices it has set up
    (``ready``) with their scan grids (``scan_blocks``); each read once."""
    global _LIB
    if _LIB is None:
        from repro_torch.kernels.build import load_libraries
        lib = load_libraries(LIBRARY)["topk_mips"]
        lib.topk_mips_f32.argtypes = _FLOAT_ARGS
        lib.topk_mips_bf16.argtypes = _FLOAT_ARGS
        lib.topk_mips_int8.argtypes = _INT8_ARGS
        lib.topk_mips_scan_f32.argtypes = _SCAN_ARGS
        for fn in (lib.topk_mips_f32, lib.topk_mips_bf16, lib.topk_mips_int8,
                   lib.topk_mips_scan_f32, lib.topk_mips_block_cols,
                   lib.topk_mips_max_candidates, lib.topk_mips_init,
                   lib.topk_mips_scan_blocks):
            fn.restype = _I
        for fn in (lib.topk_mips_block_cols, lib.topk_mips_max_candidates,
                   lib.topk_mips_init, lib.topk_mips_scan_blocks):
            fn.argtypes = []
        lib.entry = {"f32": lib.topk_mips_f32, "bf16": lib.topk_mips_bf16,
                     "int8": lib.topk_mips_int8}
        lib.cols = lib.topk_mips_block_cols()
        lib.max_cand = lib.topk_mips_max_candidates()
        lib.ready = set()
        lib.scan_blocks = {}
        _LIB = lib
    if device.index not in _LIB.ready:
        with torch.cuda.device(device):
            rc = _LIB.topk_mips_init()
            blocks = _LIB.topk_mips_scan_blocks()
        if rc == _NO_ENCODER:
            raise RuntimeError("topk_mips: cuTensorMapEncodeTiled not found")
        if rc != 0:
            raise RuntimeError(f"topk_mips_init failed with CUDA error {rc}")
        if blocks <= 0:
            raise RuntimeError(f"topk_mips_scan_blocks failed with CUDA "
                               f"error {-blocks}")
        _LIB.scan_blocks[device.index] = blocks
        _LIB.ready.add(device.index)
    return _LIB


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


def padded_dim(D: int, score_dtype: str) -> int:
    """The feature width the kernels take for ``D`` features: rows of a
    16-byte multiple, TMA's rule for the strides of a tensor map."""
    per = 16 // ELEM_BYTES[score_dtype]
    return -(-D // per) * per


def pad_features(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` (rows, D) zero-padded to ``width`` features, 16-byte aligned;
    ``x`` itself when it already is."""
    if x.shape[1] != width:
        return F.pad(x, (0, width - x.shape[1]))
    return x if x.data_ptr() % 16 == 0 else x.clone()


#: rows quantized at a time: a corpus quantized whole would hold several
#: f32 temporaries of its own size (81.6 GB beside a 27.2 GB corpus at
#: MS MARCO's 8.8 M rows x 768)
QUANT_ROWS = 1 << 18


def _quantize_rows(x: torch.Tensor):
    """:func:`quantize_int8` of a (N, D) matrix -> (values int8 (N, D),
    scales f32 (N,)), ``QUANT_ROWS`` rows at a time.  The quantization is
    per row, so the values are the ones a whole-matrix call gives."""
    if x.shape[0] <= QUANT_ROWS:
        vals, scale = quantize_int8(x)
        return vals, scale.reshape(-1).contiguous()
    vals = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for r0 in range(0, x.shape[0], QUANT_ROWS):
        v, sc = quantize_int8(x[r0:r0 + QUANT_ROWS])
        vals[r0:r0 + QUANT_ROWS] = v
        scales[r0:r0 + QUANT_ROWS] = sc.reshape(-1)
    return vals, scales


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
    qv, qs = _quantize_rows(q)
    cv, cs = _quantize_rows(c)
    return qv, cv, qs, cs


def _windows(n_valid: int, k_target: int, kc: int, cols: int,
             max_cand: int) -> List[Tuple[int, int, int, int]]:
    """Cut the first ``n_valid`` corpus rows into launches:
    ``[(w0, width, kc, k_out), ...]``.

    Pass 2 holds a row's ``kc`` carry keys and one slot for every row of the
    window's ``ceil(width / cols)`` tiles (all of them survive when the
    carry is not full) in shared memory: at most ``max_cand``.  Each window
    folds into the carry the previous one left (``kc``), keeping the
    reference's order: earlier rows win ties."""
    if kc + -(-n_valid // cols) * cols <= max_cand:     # the common case
        return [(0, n_valid, kc, min(k_target, kc + n_valid))]
    out, w0 = [], 0
    while w0 < n_valid:
        width = min(n_valid - w0, (max_cand - kc) // cols * cols)
        if width <= 0:
            raise ValueError(f"a carry of {kc} leaves no room for a tile of "
                             f"{cols} rows in {max_cand} candidates")
        k_out = min(k_target, kc + width)
        out.append((w0, width, kc, k_out))
        kc, w0 = k_out, w0 + width
    return out


def _topk_cuda(score_dtype: str, q, c, q_scale, c_scale, *, k_target: int,
               n_valid: int, carry=None, base: int = 0):
    """Top ``k_target`` of ``carry || c[:n_valid]`` per query row: by the
    scan where :func:`_takes_scan` says so, else by the tiled pass."""
    index = q.device.index
    lib = _LIB if _LIB is not None and index in _LIB.ready else _lib(q.device)
    if _takes_scan(score_dtype, q.shape[0], padded_dim(q.shape[1], "f32"),
                   k_target, n_valid, carry=carry is not None, cols=lib.cols,
                   max_cand=lib.max_cand):
        return _scan_cuda(q, c, k_target=k_target, n_valid=n_valid)
    return _tiled_cuda(score_dtype, q, c, q_scale, c_scale,
                       k_target=k_target, n_valid=n_valid, carry=carry,
                       base=base)


def _tiled_cuda(score_dtype: str, q, c, q_scale, c_scale, *, k_target: int,
                n_valid: int, carry=None, base: int = 0):
    """Top ``k_target`` of ``carry || c[:n_valid]`` per query row by the
    tiled pass, one launch per window of :func:`_windows`."""
    index = q.device.index
    lib = _LIB if _LIB is not None and index in _LIB.ready else _lib(q.device)
    cols = lib.cols
    Q, D = q.shape
    Dp = padded_dim(D, score_dtype)
    q, c = pad_features(q, Dp), pad_features(c, Dp)
    row_bytes = Dp * ELEM_BYTES[score_dtype]
    run_s, run_i = carry if carry is not None else (None, None)
    for w0, width, kc, k_out in _windows(
            n_valid, k_target, 0 if run_s is None else run_s.shape[1], cols,
            lib.max_cand):
        head = [q.data_ptr(), c.data_ptr() + w0 * row_bytes]
        if score_dtype == "int8":
            head += [q_scale.data_ptr(), c_scale.data_ptr() + 4 * w0]
        run_s, run_i = _library_call(
            f"topk_mips_{score_dtype}", lib.entry[score_dtype],
            head + [Q, width, Dp, _ptr(run_s), _ptr(run_i), kc, base + w0,
                    k_out], q.device, Q, k_out, -(-width // cols), cols)
        with _LAUNCHES_LOCK:
            launches[score_dtype] += 1
    return run_s, run_i


def _takes_scan(score_dtype: str, Q: int, D: int, k_out: int, n_valid: int,
                *, carry: bool, cols: int, max_cand: int) -> bool:
    """Whether a call takes the scan rather than the tiled pass: f32, no
    carry (:func:`topk_mips`; :func:`topk_mips_chunk` always folds one), at
    most ``SCAN_MAX_Q`` query rows of ``D`` features (the kernels' padded
    width) that fit the scan's shared memory, ``k_out <= SCAN_MAX_K``, and
    rows that :func:`_windows` would cut into more than one window of
    ``cols``-row tiles within ``max_cand`` candidates."""
    q_rows = 1 << max(0, Q - 1).bit_length()
    return (score_dtype == "f32" and not carry and 0 < Q <= SCAN_MAX_Q
            and 0 < k_out <= SCAN_MAX_K
            and q_rows * -(-D // 32) * 32 * 4 <= SCAN_QUERY_BYTES
            and -(-n_valid // cols) * cols > max_cand)


def _scan_cuda(q, c, *, k_target: int, n_valid: int):
    """Top ``k_target`` of ``c[:n_valid]`` per query row of f32 ``q`` by
    the scan: one library call, whatever the corpus's length, whose blocks
    each leave one pass-1 segment a query row."""
    global scan_calls
    index = q.device.index
    lib = _LIB if _LIB is not None and index in _LIB.ready else _lib(q.device)
    Q, D = q.shape
    Dp = padded_dim(D, "f32")
    q, c = pad_features(q, Dp), pad_features(c, Dp)
    blocks = lib.scan_blocks[index]
    out = _library_call(
        "topk_mips_scan_f32", lib.topk_mips_scan_f32,
        [q.data_ptr(), c.data_ptr(), Q, n_valid, Dp, k_target, blocks],
        q.device, Q, k_target, blocks, lib.cols)
    with _LAUNCHES_LOCK:
        launches["f32"] += 1
        scan_calls += 1
    return out


def _library_call(name: str, fn, args, device, Q: int, k_out: int,
                  n_seg: int, cols: int):
    """``fn(*args, seg, cnt, out_s, out_i, stream)`` on the current stream,
    with one allocation: out_s and out_i (Q, k_out), then the (score, row)
    pairs of Q x n_seg pass-1 segments of ``cols`` slots and their counts.
    Returns (out_s, out_i) or raises with the library's code."""
    words = Q * k_out
    buf = torch.empty((2 + -(-(2 * cols + 1) * Q * n_seg // words), Q,
                       k_out), dtype=torch.float32, device=device)
    ptr = buf.data_ptr()
    seg = ptr + 8 * words                       # 8-byte aligned pairs
    rc = fn(*args, seg, seg + 8 * cols * Q * n_seg, ptr, ptr + 4 * words,
            torch._C._cuda_getCurrentRawStream(device.index))
    if rc < 0:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled refused a "
                           f"tensor map (CUresult {-rc})")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    return buf[0], buf[1].view(torch.int32)


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
    the card the carry is merged inside the kernel's second pass; it must
    be in the output order (a previous result, or a constant fill), as the
    engine's always is, since the kernel reads its k-th score as the
    threshold a chunk score must beat."""
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
