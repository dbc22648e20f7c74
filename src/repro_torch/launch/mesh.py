"""Mesh construction (``repro/launch/mesh.py``); functions only.

Importing this module touches no device.  :func:`make_production_mesh`
gives the reference's production layouts, ``("data", "model")`` 16 x 16
and ``("pod", "data", "model")`` 2 x 16 x 16, as a
:class:`~repro_torch.distributed.compat.DeviceMesh` of meta devices by
default: the launch steps (``launch/steps.py``) and the dry run
(``launch/dryrun.py``) read its axis sizes to lay their arrays out, and no
data is placed on it.

Asyncval's deployment splits the device set: one part trains, the other
validates, and the checkpoint directory is the only coupling between them
(:func:`make_disaggregated_meshes`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.distributed import compat


def _visible(device: str) -> List[torch.device]:
    """The devices of kind ``device`` this process can use: every CUDA
    device for ``"cuda"`` (raises when there is none), the CPU for
    ``"cpu"``, the meta device for ``"meta"``."""
    if torch.device(device).type in ("cpu", "meta"):
        return [torch.device(torch.device(device).type)]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                           "for a CPU mesh")
    return [torch.device("cuda", i) for i in range(n)]


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "meta") -> compat.DeviceMesh:
    """The production layout: ``("data", "model")`` 16 x 16 (256 entries)
    or, with ``multi_pod``, ``("pod", "data", "model")`` 2 x 16 x 16 (512):
    data parallelism over ``("pod", "data")``, tensor / expert parallelism
    on ``"model"``.  The entries are ``device``'s visible devices taken
    round-robin (meta by default: a layout only)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devices = _visible(device)
    n = 512 if multi_pod else 256
    return compat.make_mesh(shape, axes,
                            [devices[i % len(devices)] for i in range(n)])


def make_validator_mesh(n_devices: Optional[int] = None, *,
                        model_axis: int = 1,
                        device: str = "cuda") -> compat.DeviceMesh:
    """Elastic ``("data", "model")`` validator mesh of ``n_devices`` shards
    (default: one per visible device; corpus encoding is data-parallel, so
    ``model_axis`` defaults to 1).  More shards than visible devices take
    the devices round-robin: the mesh then repeats them."""
    devices = _visible(device)
    n = n_devices or len(devices)
    if n % model_axis:
        raise ValueError(f"{n} devices do not divide model_axis "
                         f"{model_axis}")
    return compat.make_mesh((n // model_axis, model_axis), ("data", "model"),
                            [devices[i % len(devices)] for i in range(n)])


def make_disaggregated_meshes(device: str = "cuda"
                              ) -> Tuple[compat.DeviceMesh,
                                         compat.DeviceMesh]:
    """(train_mesh, validator_mesh) over disjoint halves of the visible
    devices: the Asyncval deployment, one half trains and the other
    validates.  Needs at least two devices."""
    devices = _visible(device)
    if len(devices) < 2:
        raise RuntimeError(f"disaggregation needs >= 2 devices, "
                           f"{len(devices)} visible")
    half = len(devices) // 2
    train = compat.make_mesh((half, 1), ("data", "model"), devices[:half])
    val = compat.make_mesh((half, 1), ("data", "model"),
                           devices[half:2 * half])
    return train, val
