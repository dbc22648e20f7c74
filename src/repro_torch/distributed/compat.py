"""The single-controller device mesh: the port's ``jax.sharding.Mesh``.

One process holds a :class:`DeviceMesh` and passes it around as a value,
as the reference passes its ``Mesh``: ``ValidationConfig.mesh``,
``ServeConfig.mesh``, ``make_stage(mesh=)``, ``retrieve_run(mesh=)``.

The reference's ``compat.shard_map`` has no counterpart here.  Its sharded
functions run one ``jax.shard_map`` program over the mesh; the port's
(:func:`repro_torch.core.retrieval.topk_sharded`, the engine's sharded
stages, the sharded serving index) loop over the shards explicitly, each
shard's rows on that shard's device, and merge the shards' results one
mesh axis at a time, innermost first, as the reference's collectives do.

A device may repeat.  ``make_mesh((4, 2), ("data", "model"),
devices=[torch.device("cpu")] * 8)`` or ``devices=[cuda:0] * 4`` runs the
whole sharded code (the row split, the per-shard offsets, the pads, the
hierarchical merge) on one device: that is how the CPU tests and a
one-card machine exercise it, in place of the reference tests' forced host
devices.  On a host with several cards the mesh takes ``cuda:0..n-1`` and
each shard runs on its own card.  A device that is not available raises.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _checked(device) -> torch.device:
    """``device`` as a ``torch.device`` with an explicit CUDA index; raises
    when the device is not available in this process.  ``meta`` is always
    available: a mesh of meta devices describes a layout (the production
    meshes of ``launch/mesh.py``) and holds no data."""
    dev = torch.device(device)
    if dev.type in ("cpu", "meta"):
        return dev
    if dev.type != "cuda":
        raise ValueError(f"mesh devices are cpu, cuda or meta, got {dev}")
    index = 0 if dev.index is None else dev.index
    if not torch.cuda.is_available() or index >= torch.cuda.device_count():
        raise RuntimeError(f"mesh device {dev} is not available "
                           f"({torch.cuda.device_count()} CUDA devices "
                           "visible)")
    return torch.device("cuda", index)


class DeviceMesh:
    """An array of ``torch.device`` shaped like the mesh's axes.

    ``devices`` is a numpy object array of shape ``axis_shapes`` (so
    ``devices.size`` is the shard count over every axis), ``axis_names``
    names its axes, and ``shape`` maps each name to its size, as
    ``jax.sharding.Mesh`` has them."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names, got "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"duplicate mesh axis names {self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def is_meta(self) -> bool:
        """True for a mesh of meta devices: a layout, where no shard holds
        data (see :func:`check_placeable`)."""
        return self.home.type == "meta"

    @property
    def home(self) -> torch.device:
        """The first device: where merged, replicated results land."""
        return self.devices.flat[0]

    def distinct_devices(self) -> List[torch.device]:
        """Each device once, in mesh order."""
        out: List[torch.device] = []
        for dev in self.devices.flat:
            if dev not in out:
                out.append(dev)
        return out

    def __repr__(self) -> str:
        return (f"DeviceMesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def check_placeable(mesh: DeviceMesh, tensor) -> None:
    """Raises unless ``tensor`` may be placed on ``mesh``'s devices: a meta
    mesh takes only meta tensors, since moving data to a meta device would
    drop it silently.  (A meta tensor split over a meta mesh moves nothing;
    that is how a dry run runs a sharded step.)"""
    if mesh.is_meta and not (isinstance(tensor, torch.Tensor)
                             and tensor.device.type == "meta"):
        where = tensor.device if isinstance(tensor, torch.Tensor) \
            else type(tensor).__name__
        raise RuntimeError(
            "a mesh of meta devices describes a layout and holds no data: "
            f"cannot place data ({where}) onto it; build the mesh over cpu "
            "or cuda devices to run a sharded path")


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A :class:`DeviceMesh` of ``axis_shapes`` over ``devices`` (row-major;
    default: every visible CUDA device), which must number exactly the
    product of the shapes.  A device may appear more than once."""
    shape = tuple(int(n) for n in axis_shapes)
    if len(shape) != len(tuple(axis_names)):
        raise ValueError(f"axis_shapes {shape} and axis_names "
                         f"{tuple(axis_names)} differ in length")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [_checked(d) for d in devices]
    if len(devs) != math.prod(shape):
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} "
                         f"devices, got {len(devs)}")
    arr = np.empty(len(devs), dtype=object)
    for i, dev in enumerate(devs):
        arr[i] = dev
    return DeviceMesh(arr.reshape(shape), axis_names)
