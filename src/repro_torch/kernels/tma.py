"""Geometry of the 4-D TMA tensor maps through which the attention kernels
(``csrc/flash_attention.cu`` at bf16, ``csrc/decode_attention.cu``) read
their (B, heads, seq, d) operands.

The kernels encode the maps with ``cuTensorMapEncodeTiled``; the geometry
is computed here, in tested Python, and raises on what TMA refuses (a base
that is not 16-byte aligned, a stride that is not a multiple of 16 bytes),
so the kernels read strided views such as the trunk's ``x.transpose(1, 2)``
as they are, without a copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

__all__ = ["TensorMap", "tensor_map_geometry"]


@dataclass(frozen=True)
class TensorMap:
    """Geometry of one 4-D TMA tensor map over a (B, heads, seq, d) tensor,
    innermost first, as ``cuTensorMapEncodeTiled`` takes it."""
    dims: Tuple[int, int, int, int]      # (d, seq, heads, B)
    strides: Tuple[int, int, int]        # bytes between seq, head, batch
    box: Tuple[int, int, int, int]       # (columns, rows, 1, 1)
    swizzle: int                         # bytes of a swizzled row

    def flat(self) -> Tuple[int, ...]:
        return (*self.dims, *self.strides, *self.box, self.swizzle)


def tensor_map_geometry(t: torch.Tensor, rows: int) -> TensorMap:
    """The tensor map through which a kernel reads ``t`` (B, heads, seq, d)
    in boxes of ``rows`` rows.

    A row of the box is d padded to 16 columns (wgmma's and mma's k16; TMA
    fills the columns past d with zeros), swizzled by its width up to 128
    bytes; a wider row is read as several boxes of 128 bytes.  Strides come
    from the tensor as it is, so transposed views need no copy.  Raises
    ``ValueError`` on what TMA refuses."""
    if t.dim() != 4 or t.stride(3) != 1:
        raise ValueError(f"expected a (B, heads, seq, d) tensor with a "
                         f"contiguous last dim, got shape {tuple(t.shape)} "
                         f"strides {t.stride()}")
    B, heads, L, d = t.shape
    es = t.element_size()
    if t.data_ptr() % 16:
        raise ValueError(f"TMA needs a 16-byte aligned base; this tensor "
                         f"starts at {t.data_ptr():#x}")
    strides = []
    for axis in (2, 1, 0):                       # seq, head, batch
        nbytes = t.stride(axis) * es
        if t.shape[axis] == 1:
            # never stepped over: any stride TMA takes will do
            nbytes = max(16, -(-nbytes // 16) * 16)
        elif nbytes <= 0 or nbytes % 16 or nbytes >= 1 << 40:
            raise ValueError(f"TMA needs strides that are positive "
                             f"multiples of 16 bytes; axis {axis} of shape "
                             f"{tuple(t.shape)} steps {nbytes} bytes")
        strides.append(nbytes)
    swizzle = min(max(d, 16) * es, 128)
    return TensorMap(dims=(d, L, heads, B), strides=tuple(strides),
                     box=(swizzle // es, rows, 1, 1), swizzle=swizzle)
