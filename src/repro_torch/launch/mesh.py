"""Validator mesh construction (``repro/launch/mesh.py``); functions only.

Importing this module touches no device.  The reference's
``make_production_mesh`` (the 16 x 16 TPU pod layout of its LM launch
steps) has no consumer in the port yet and is not here.

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
    ``"cpu"``."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                           "for a CPU mesh")
    return [torch.device("cuda", i) for i in range(n)]


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
