"""Host-resident parameter snapshots: the unit the hand-off channel moves
(``repro/handoff/snapshot.py``).

A :class:`ParamSnapshot` is one step's state tree flattened to numpy leaves
plus the serialized treedef: the ``(leaves, treedef)`` encoding
:mod:`repro_torch.ckpt.checkpoint` writes to disk, minus the disk.  The
treedef is :func:`~repro_torch.ckpt.checkpoint.treedef_proto`'s bytes, which
are JAX's, so the reference's ``ParamSnapshot.state()`` reads a port
snapshot from a spool and the port reads the reference's.  bf16 leaves
travel as ``uint16`` views (``Tensor.numpy()`` refuses bf16), with
``"bfloat16"`` in :attr:`ParamSnapshot.dtypes`, as the checkpoint manifest
names them.

:meth:`ParamSnapshot.state` rebuilds the tree of CPU tensors that
``ckpt.restore`` would return for the same step, so validating from a
snapshot is bit for bit validating the durable checkpoint; the encoder
uploads the leaves where it uploads a restored tree, on the validator's own
CUDA stream.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import pytree


def _host_leaf(leaf):
    """``(array, dtype name)`` of one leaf.  A CPU tensor that is not in
    pinned memory may be a live tensor of the caller (on the CPU the async
    saver hands the trainer's own tree to its hooks), so it is copied; a
    pinned tensor is a host copy made for the save and is viewed, as are
    numpy arrays."""
    if isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu" \
            and not leaf.is_pinned():
        leaf = leaf.detach().clone()
    return ckpt._to_numpy(leaf)


@dataclasses.dataclass
class ParamSnapshot:
    """One step's host-resident state.

    ``leaves`` are numpy arrays in leaf order (the bytes ``ckpt.save``
    writes); ``treedef_hex`` is the tree's structure in the checkpoint
    manifest's encoding; ``dtypes`` the manifest's dtype name per leaf
    (``None``: each array's own)."""

    step: int
    leaves: List[np.ndarray]
    treedef_hex: str
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    dtypes: Optional[List[str]] = None

    @classmethod
    def from_tree(cls, step: int, tree: Any,
                  extra: Optional[dict] = None) -> "ParamSnapshot":
        """Flatten ``tree`` (tensors on any device, or numpy arrays) into a
        snapshot.  A CUDA leaf is copied to the host here, synchronously:
        callers on the training hot path hand over the pinned host copy of
        ``ckpt.AsyncSaver`` instead (its ``on_host_copy`` hook)."""
        leaves, _ = pytree.tree_flatten(tree)
        host = [_host_leaf(leaf) for leaf in leaves]
        return cls(step=int(step), leaves=[a for a, _ in host],
                   treedef_hex=ckpt.treedef_proto(tree).hex(),
                   extra=dict(extra or {}),
                   dtypes=[name for _, name in host])

    def _tensor(self, i: int) -> torch.Tensor:
        arr = self.leaves[i]
        name = self.dtypes[i] if self.dtypes is not None else str(arr.dtype)
        if not arr.flags.writeable:         # e.g. a spool's mmap'd leaf
            arr = arr.copy()
        if name == "bfloat16":
            if arr.dtype.itemsize != 2:
                raise ValueError(f"snapshot step {self.step}: leaf {i} is "
                                 f"named bfloat16 but holds {arr.dtype}")
            # np.require keeps a 0-d leaf 0-d (ascontiguousarray makes it 1-d)
            return torch.from_numpy(np.require(arr, requirements="C")
                                    .view(np.int16)).view(torch.bfloat16)
        if str(arr.dtype) != name:
            raise ValueError(f"snapshot step {self.step}: leaf {i} is named "
                             f"{name} but holds {arr.dtype}")
        return torch.from_numpy(np.require(arr, requirements="C"))

    def state(self, *, device=None) -> Any:
        """Rebuild the state tree: CPU tensors (``ckpt.restore``'s return
        value), or tensors on ``device`` when given; the copies run on the
        caller's current CUDA stream."""
        skeleton = ckpt.treedef_skeleton(self.treedef_hex)
        leaves = [self._tensor(i) for i in range(len(self.leaves))]
        if device is not None:
            leaves = [t.to(device) for t in leaves]
        return skeleton.unflatten(leaves)

    @property
    def nbytes(self) -> int:
        return sum(int(x.nbytes) for x in self.leaves)
