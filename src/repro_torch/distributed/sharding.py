"""Placements on a :class:`~repro_torch.distributed.compat.DeviceMesh`.

The reference's ``rows_sharding`` / ``replicated_sharding`` are
``NamedSharding``\\ s that ``jax.device_put`` lays an array out with.  Here
they are the placements themselves:

  * :func:`rows_sharding` splits a tensor's leading (rows) dim into equal
    blocks over the named mesh axes (jointly when several, the first axis
    major), block ``i`` on the device of shard ``i``: a
    :class:`ShardedRows`.  The streaming engine stages its token chunks
    this way, and the sharded serving index holds its corpus so.
  * :func:`replicated_sharding` puts a tensor (or a tree of them) on every
    distinct device of the mesh once: :class:`Replicas`.  The sharded
    stages keep their query matrix and params this way.

Shard ``i`` of ``axis_names`` is the mesh position whose coordinates along
those axes, read row-major, give ``i``, at coordinate 0 of every other
axis: the reference's ``axis_index`` over the same names.

The reference's LM sharding rules (``Rules``, ``spec_for``,
``tree_shardings``, ...) have no consumer in the port yet and are not here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.compat import DeviceMesh
from repro_torch.models.nn import to_torch_tree


def shard_devices(mesh: DeviceMesh,
                  axis_names: Sequence[str]) -> List[torch.device]:
    """The device of each shard of ``axis_names``, in shard order."""
    names = tuple(axis_names)
    unknown = [a for a in names if a not in mesh.axis_names]
    if unknown or not names:
        raise ValueError(f"axis names {names} not in mesh axes "
                         f"{mesh.axis_names}")
    sub = mesh.devices[tuple(slice(None) if a in names else 0
                             for a in mesh.axis_names)]
    kept = [a for a in mesh.axis_names if a in names]
    sub = np.transpose(sub, [kept.index(a) for a in names])
    return list(sub.reshape(-1))


@dataclasses.dataclass
class ShardedRows:
    """A ``(rows, ...)`` tensor as equal row blocks, shard ``i``'s block on
    its device: the rows ``[i * rows_per_shard, (i + 1) * rows_per_shard)``
    of the whole."""

    shards: List[torch.Tensor]

    @property
    def rows(self) -> int:
        """Rows per shard."""
        return int(self.shards[0].shape[0])

    @property
    def shape(self) -> Tuple[int, ...]:
        first = self.shards[0].shape
        return (first[0] * len(self.shards),) + tuple(first[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on ``device``."""
        return torch.cat([s.to(device) for s in self.shards])


class RowsSharding:
    """Splits rows over the shards of ``axis_names`` (see module doc)."""

    def __init__(self, mesh: DeviceMesh,
                 axis_names: Optional[Sequence[str]] = None):
        self.mesh = mesh
        self.axis_names = tuple(axis_names or mesh.axis_names)
        self.devices = shard_devices(mesh, self.axis_names)

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    def split(self, x):
        """``x`` (a tensor or numpy array) as ``n_shards`` row blocks, not
        yet moved; raises unless the rows divide the shards."""
        n = x.shape[0]
        if n % self.n_shards:
            raise ValueError(f"{n} rows do not divide {self.n_shards} "
                             "shards (pad first)")
        rows = n // self.n_shards
        return [x[i * rows:(i + 1) * rows] for i in range(self.n_shards)]

    def put(self, x: torch.Tensor) -> ShardedRows:
        """Each row block of ``x`` on its shard's device (a view where the
        block already lies there)."""
        return ShardedRows([blk.to(dev) for blk, dev
                            in zip(self.split(x), self.devices)])


@dataclasses.dataclass
class Replicas:
    """One copy of a value per distinct mesh device."""

    copies: Dict[torch.device, Any]

    def on(self, device) -> Any:
        return self.copies[torch.device(device)]


class Replicated:
    """Places a tensor, or a tree of them, on every distinct device."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh

    def put(self, tree: Any) -> Replicas:
        """A copy per device (the value itself where it already lies
        there)."""
        return Replicas({dev: to_torch_tree(tree, dev)
                         for dev in self.mesh.distinct_devices()})


def rows_sharding(mesh: DeviceMesh,
                  axis_names: Optional[Sequence[str]] = None
                  ) -> RowsSharding:
    """The placement that splits a tensor's rows over ``axis_names``
    (default: every mesh axis, jointly)."""
    return RowsSharding(mesh, axis_names)


def replicated_sharding(mesh: DeviceMesh) -> Replicated:
    """The placement that puts a value on every device of ``mesh``."""
    return Replicated(mesh)


def batch_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Mesh axes used for data parallelism ("pod" joins "data" if
    present)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
