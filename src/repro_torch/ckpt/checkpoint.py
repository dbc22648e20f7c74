"""Checkpoint directories in the reference's two-phase-commit format.

Layout (one directory per step under a checkpoint root), as the JAX package
writes it:

    <root>/step_0000001000/
        manifest.json     # treedef, per-leaf shape/dtype, user metadata
        arrays/00000.npy  # one .npy per leaf, in tree_flatten order
        COMMIT            # written LAST: readers only see finished steps

Leaves are stored in JAX's ``tree_flatten`` order, which for nested dicts is
the order of the sorted keys at every level.  The manifest's ``treedef`` is
a JAX protobuf, which this package does not read: :func:`restore` rebuilds
the tree from a *template* — a nested dict with the same keys as the saved
tree, whose leaves are the expected shapes (a tuple) or ``None`` — and
checks every leaf's shape and dtype against the manifest.

bf16 leaves come back from ``np.load`` as 2-byte void records (the JAX
package writes them through ``ml_dtypes``).  They are viewed as ``uint16``
and then as ``torch.bfloat16``, so no ``ml_dtypes`` is needed.  Leaves are
returned as CPU tensors.

A checkpoint written by :func:`save` here stores ``"treedef": null`` and the
leaves' key paths; ``repro.ckpt.restore`` of the JAX package cannot read it.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

COMMIT_MARKER = "COMMIT"
STEP_PREFIX = "step_"


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"{STEP_PREFIX}{step:010d}")


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(key path, leaf), ...]`` in ``jax.tree_util.tree_flatten`` order
    (sorted dict keys at every level)."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for key in sorted(tree):
            out.extend(flatten(tree[key], f"{prefix}/{key}" if prefix
                               else str(key)))
        return out
    return [(prefix, tree)]


def _unflatten(template: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)

    return build(template)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to write, manifest dtype name) for a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(root: str, step: int, tree: Any, extra: Optional[dict] = None) -> str:
    """Two-phase-commit checkpoint write. Returns the committed directory."""
    os.makedirs(root, exist_ok=True)
    final = _step_dir(root, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    arrays_dir = os.path.join(tmp, "arrays")
    os.makedirs(arrays_dir)
    flat = flatten(tree)
    manifest = {"step": step, "treedef": None,
                "keypaths": [path for path, _ in flat], "leaves": [],
                "extra": extra or {}}
    for i, (_, leaf) in enumerate(flat):
        arr, dtype = _to_numpy(leaf)
        with open(os.path.join(arrays_dir, f"{i:05d}.npy"), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append({"shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):          # idempotent re-save (restart replay)
        shutil.rmtree(final)
    os.rename(tmp, final)
    # phase 2: commit marker — readers must ignore directories without it
    with open(os.path.join(final, COMMIT_MARKER), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    try:
        _fsync_dir(final)
    except FileNotFoundError:
        pass    # a consumer validated and evicted it already; nothing to sync
    return final


def is_committed(path: str) -> bool:
    return os.path.exists(os.path.join(path, COMMIT_MARKER))


def list_steps(root: str) -> List[int]:
    """Committed checkpoint steps, ascending."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if name.startswith(STEP_PREFIX) and not name.endswith(".tmp"):
            if is_committed(os.path.join(root, name)):
                try:
                    steps.append(int(name[len(STEP_PREFIX):]))
                except ValueError:
                    continue
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    steps = list_steps(root)
    return steps[-1] if steps else None


def _read_manifest(root: str, step: int) -> Tuple[str, dict]:
    path = _step_dir(root, step)
    if not is_committed(path):
        raise FileNotFoundError(f"checkpoint {path} not committed")
    with open(os.path.join(path, "manifest.json")) as f:
        return path, json.load(f)


def read_extra(root: str, step: int) -> dict:
    """The manifest's user metadata, without loading any arrays."""
    return _read_manifest(root, step)[1].get("extra", {})


def _load_leaf(path: str, meta: dict) -> torch.Tensor:
    arr = np.load(path)
    want = meta["dtype"]
    if want == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"{path}: manifest says bfloat16, file holds "
                             f"{arr.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        if str(arr.dtype) != want:
            raise ValueError(f"{path}: manifest says {want}, file holds "
                             f"{arr.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if list(t.shape) != list(meta["shape"]):
        raise ValueError(f"{path}: manifest shape {meta['shape']}, file "
                         f"holds {list(t.shape)}")
    return t


def restore(root: str, step: Optional[int] = None, *,
            template: Dict[str, Any]) -> Tuple[Any, dict]:
    """Restore ``(tree, extra)`` of a committed step (default: the latest).

    ``template`` gives the tree's structure (see the module docstring).
    Raises ``ValueError`` when the leaf count, a leaf's dtype or a leaf's
    shape disagrees with the manifest or the template."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints under {root}")
    path, manifest = _read_manifest(root, step)
    slots = flatten(template)
    metas = manifest["leaves"]
    if len(slots) != len(metas):
        raise ValueError(f"{path} holds {len(metas)} leaves; the template "
                         f"has {len(slots)}")
    saved_paths = manifest.get("keypaths")
    if saved_paths is not None and saved_paths != [p for p, _ in slots]:
        raise ValueError(f"{path}: key paths differ from the template")
    leaves = []
    for i, ((key, want), meta) in enumerate(zip(slots, metas)):
        if want is not None and list(want) != list(meta["shape"]):
            raise ValueError(f"{path}: leaf {key} has shape {meta['shape']},"
                             f" the template expects {list(want)}")
        leaves.append(_load_leaf(os.path.join(path, "arrays", f"{i:05d}.npy"),
                                 meta))
    return _unflatten(template, leaves), manifest.get("extra", {})
