"""Checkpoint directories in the reference's two-phase-commit format.

Layout (one directory per step under a checkpoint root), as the JAX package
writes it:

    <root>/step_0000001000/
        manifest.json     # treedef, per-leaf shape/dtype, user metadata
        arrays/00000.npy  # one .npy per leaf, in tree_flatten order
        COMMIT            # written LAST: readers only see finished steps

Leaves are stored in JAX's ``tree_flatten`` order, which for nested dicts is
the order of the sorted keys at every level.  The manifest's ``treedef`` is
the hex of ``jax.tree_util`` ``serialize_using_proto()``;
:func:`treedef_keypaths` decodes it in pure Python (dict, list, tuple and
None nodes) into each leaf's key path.  :func:`restore` takes a *template*
— a nested dict whose leaves are the expected shapes (a tuple) or ``None``
— and restores that subtree by key path out of whatever larger tree was
saved (a trainer's ``{"params", "opt_state"}``, say), checking every
leaf's shape and dtype against the manifest.

bf16 leaves come back from ``np.load`` as 2-byte void records (the JAX
package writes them through ``ml_dtypes``).  They are viewed as ``uint16``
and then as ``torch.bfloat16``, so no ``ml_dtypes`` is needed.  Leaves are
returned as CPU tensors.

:func:`save` writes the same format: the manifest's ``treedef`` is encoded
in pure Python (:func:`treedef_proto`, byte for byte what
``serialize_using_proto()`` gives for dict, list, tuple and None nodes), so
``repro.ckpt.restore`` of the JAX package reads a port checkpoint, and the
manifest also lists each leaf's key path (``"keypaths"``), which the
reference's reader ignores.

:class:`AsyncSaver` saves in the background: the calling thread only
enqueues the device-to-host copies (pinned host buffers, ``non_blocking``
copies on a side stream, one CUDA event); a background thread waits on the
event and writes the checkpoint.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, \
    Union

import numpy as np
import torch

from repro_torch.core import pytree

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
    """``[(key path, leaf), ...]`` of a nested dict in ``jax.tree_util.
    tree_flatten`` order (sorted dict keys at every level); anything that
    is not a dict is a leaf, so a restore template's shape tuples are
    leaves here."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for key in sorted(tree):
            out.extend(flatten(tree[key], f"{prefix}/{key}" if prefix
                               else str(key)))
        return out
    return [(prefix, tree)]


# ---------------------------------------------------------------------------
# The reference manifest's treedef: jax.tree_util's PyTreeDefProto
# ---------------------------------------------------------------------------

#: PyTreeDefProto node kinds the decoder reads (jaxlib's pytree.proto)
_LEAF, _LIST, _NONE, _TUPLE, _DICT = 1, 2, 3, 4, 5
_KIND_NAMES = {_LEAF: "leaf", _LIST: "list", _NONE: "None", _TUPLE: "tuple",
               _DICT: "dict"}

KeyPath = Tuple[Union[str, int], ...]


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("treedef: truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes):
    """``(field number, value)`` of a protobuf message: an int for a varint,
    bytes for a length-delimited field; any other wire type raises."""
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 2:
            n, pos = _varint(buf, pos)
            if pos + n > len(buf):
                raise ValueError("treedef: truncated field")
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"treedef: unexpected wire type {wire} in "
                             f"field {field}")
        yield field, value


def _dict_key_ids(buf: bytes) -> List[int]:
    """DictKeysProto: ``repeated uint32 str_id = 1``, packed or not."""
    ids: List[int] = []
    for field, value in _fields(buf):
        if field != 1:
            raise ValueError(f"treedef: unexpected dict-keys field {field}")
        if isinstance(value, int):
            ids.append(value)
        else:
            pos = 0
            while pos < len(value):
                v, pos = _varint(value, pos)
                ids.append(v)
    return ids


def _treedef_root(treedef: Union[str, bytes]):
    """Decode a manifest ``treedef`` (hex string or bytes) into its root
    node: ``("leaf",)``, ``("none",)``, ``("dict", [(key, child), ...])``,
    ``("list", [child, ...])`` or ``("tuple", [child, ...])``, children in
    leaf order.  The proto lists nodes in post-order (children before their
    parent), each with its kind, arity and, for a dict, the ids of its keys
    in an interned-string table.  Node kinds other than dict, list, tuple,
    None and leaf raise ``ValueError``."""
    buf = bytes.fromhex(treedef) if isinstance(treedef, str) else treedef
    nodes, strings = [], []
    for field, value in _fields(buf):
        if field == 1 and isinstance(value, bytes):
            nodes.append(value)
        elif field == 2 and isinstance(value, bytes):
            strings.append(value.decode("utf-8"))
        else:
            raise ValueError(f"treedef: unexpected field {field}")
    stack: List[Any] = []
    for raw in nodes:
        arity, kind, key_ids = 0, 0, []
        for field, value in _fields(raw):
            if field == 1 and isinstance(value, int):
                arity = value
            elif field == 2 and isinstance(value, int):
                kind = value
            elif field == 3 and isinstance(value, bytes):
                key_ids = _dict_key_ids(value)
            else:
                raise ValueError(f"treedef: unexpected node field {field}")
        if kind not in _KIND_NAMES:
            raise ValueError(f"treedef: node kind {kind} is not supported "
                             "(only dict, list, tuple, None and leaves)")
        if arity > len(stack):
            raise ValueError(f"treedef: a {_KIND_NAMES[kind]} node of "
                             f"arity {arity} has {len(stack)} children")
        children = stack[len(stack) - arity:] if arity else []
        del stack[len(stack) - arity:]
        if kind == _DICT:
            if len(key_ids) != arity:
                raise ValueError(f"treedef: a dict of arity {arity} has "
                                 f"{len(key_ids)} keys")
            if any(i >= len(strings) for i in key_ids):
                raise ValueError(f"treedef: dict key ids {key_ids} outside "
                                 f"a table of {len(strings)} strings")
            stack.append(("dict", [(strings[i], c)
                                   for i, c in zip(key_ids, children)]))
        elif kind in (_LIST, _TUPLE):
            stack.append((_KIND_NAMES[kind], children))
        else:
            stack.append(("leaf",) if kind == _LEAF else ("none",))
    if len(stack) != 1:
        raise ValueError(f"treedef: {len(stack)} roots")
    return stack[0]


def treedef_keypaths(treedef: Union[str, bytes]) -> List[KeyPath]:
    """Each leaf's key path, in leaf order, from a reference manifest's
    ``treedef`` (hex string or bytes): a tuple of dict keys (str) and
    list / tuple indices (int), as ``jax.tree_util.tree_flatten_with_path``
    gives them.  Node kinds other than dict, list, tuple, None and leaf
    raise ``ValueError``."""
    out: List[KeyPath] = []

    def walk(node, prefix):
        kind = node[0]
        if kind == "leaf":
            out.append(prefix)
        elif kind == "dict":
            for key, child in node[1]:
                walk(child, prefix + (key,))
        elif kind in ("list", "tuple"):
            for i, child in enumerate(node[1]):
                walk(child, prefix + (i,))

    walk(_treedef_root(treedef), ())
    return out


def treedef_skeleton(treedef: Union[str, bytes]) -> pytree.TreeDef:
    """The tree structure a manifest ``treedef`` encodes, as a
    :class:`~repro_torch.core.pytree.TreeDef` whose ``unflatten`` rebuilds
    the tree from its leaves in leaf order (dicts, lists, tuples and None
    nodes as they were saved)."""
    def build(node):
        kind = node[0]
        if kind == "leaf":
            return pytree._LEAF
        if kind == "none":
            return None
        if kind == "dict":
            return {key: build(child) for key, child in node[1]}
        children = [build(child) for child in node[1]]
        return children if kind == "list" else tuple(children)

    return pytree.TreeDef(build(_treedef_root(treedef)))


def _varint_bytes(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(field: int, payload: Union[int, bytes]) -> bytes:
    """One protobuf field: a varint for an int, length-delimited bytes
    otherwise."""
    if isinstance(payload, int):
        return _varint_bytes(field << 3) + _varint_bytes(payload)
    return _varint_bytes(field << 3 | 2) + _varint_bytes(len(payload)) \
        + payload


def treedef_proto(tree: Any) -> bytes:
    """The inverse of :func:`treedef_keypaths`: ``tree``'s structure as
    ``jax.tree_util.tree_structure(tree).serialize_using_proto()`` gives
    it.  Nodes in post-order, each with its arity (left out when 0), its
    kind and, for a dict, the ids of its keys in sorted order; a key string
    is interned when the first dict holding it is written.  Dict keys must
    be strings; node kinds other than dict, list, tuple and None raise."""
    nodes: List[bytes] = []
    strings: Dict[str, int] = {}

    def node(arity: int, kind: int, key_ids: Optional[List[int]] = None):
        msg = (_field(1, arity) if arity else b"") + _field(2, kind)
        if key_ids:
            packed = b"".join(_varint_bytes(i) for i in key_ids)
            msg += _field(3, _field(1, packed))
        nodes.append(msg)

    def walk(x):
        kind = pytree._kind(x)
        if kind == "dict":
            keys = sorted(x)
            bad = [k for k in keys if not isinstance(k, str)]
            if bad:
                raise ValueError(f"treedef: dict keys must be strings, got "
                                 f"{bad[:3]}")
            for key in keys:
                walk(x[key])
            node(len(keys), _DICT,
                 [strings.setdefault(k, len(strings)) for k in keys])
        elif kind in ("list", "tuple"):
            for child in x:
                walk(child)
            node(len(x), _LIST if kind == "list" else _TUPLE)
        elif kind == "none":
            node(0, _NONE)
        else:
            node(0, _LEAF)

    walk(tree)
    return b"".join(_field(1, n) for n in nodes) \
        + b"".join(_field(2, s.encode("utf-8")) for s in strings)


def _path_name(keypath: KeyPath) -> str:
    """A key path in :func:`flatten`'s ``a/b/c`` form."""
    return "/".join(str(k) for k in keypath)


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
    flat = pytree.tree_flatten_with_path(tree)
    manifest = {"step": step, "treedef": treedef_proto(tree).hex(),
                "keypaths": [_path_name(path) for path, _ in flat],
                "leaves": [], "extra": extra or {}}
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


def _start_host_copy(tree: Any) -> Tuple[Any, Optional[torch.cuda.Event]]:
    """Enqueue the device-to-host copy of every CUDA leaf of ``tree`` and
    return ``(host tree, event)`` without waiting for any of them.

    Each CUDA leaf is copied into a pinned host tensor by a ``non_blocking``
    copy on a side stream that first waits for the work already queued on
    the caller's stream (the step that produced the leaf); one event,
    recorded after the last copy, tells the reader when the host tree is
    whole (``None`` when no leaf is on a card).  ``record_stream`` keeps the
    caching allocator from handing a leaf's memory to later work before the
    copy has read it, so the caller may drop or rebind its tensors at once;
    an in-place write to a leaf before the event would still race the
    copy, which is why the trainer's optimizer returns new tensors."""
    leaves, treedef = pytree.tree_flatten(tree)
    devices = {leaf.device for leaf in leaves
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    if len(devices) > 1:
        raise ValueError(f"a checkpoint tree on several cards: {devices}")
    if not devices:
        return tree, None
    device = devices.pop()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    host = []
    with torch.cuda.stream(side):
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                h = torch.empty(leaf.shape, dtype=leaf.dtype,
                                pin_memory=True)
                h.copy_(leaf.detach(), non_blocking=True)
                leaf.record_stream(side)
                host.append(h)
            else:
                host.append(leaf)
        done = torch.cuda.Event()
        done.record(side)
    return treedef.unflatten(host), done


class AsyncSaver:
    """Background checkpoint writer: training waits neither on the disk nor
    on the device-to-host copy.

    One save in flight at a time (a new ``save`` waits for the previous one,
    so the trainer waits only if it outruns the disk).  The calling thread
    only enqueues the copies (:func:`_start_host_copy`); the background
    thread waits on their event, then writes with :func:`save`.

    Hooks (optional, called on the background thread): ``on_host_copy(step,
    host_tree)`` once the host copy is whole, before the durable write;
    ``on_durable(step)`` after the two-phase commit; ``on_failure(step,
    exc)`` if the write raises.  An error is raised again by the next
    :meth:`wait` (or ``save``)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, root: str, step: int, tree: Any,
             extra: Optional[dict] = None, *,
             on_host_copy: Optional[Callable] = None,
             on_durable: Optional[Callable] = None,
             on_failure: Optional[Callable] = None) -> None:
        self.wait()
        host_tree, done = _start_host_copy(tree)

        def _run():
            try:
                if done is not None:
                    done.synchronize()
                if on_host_copy is not None:
                    try:
                        on_host_copy(step, host_tree)
                    except BaseException as e:
                        # a failed hand-off must not cost the checkpoint
                        self._error = e
                save(root, step, host_tree, extra)
            except BaseException as e:   # raised again by the next wait()
                self._error = e
                if on_failure is not None:
                    try:
                        on_failure(step, e)
                    except BaseException:
                        pass             # the save's error takes precedence
                return
            if on_durable is not None:
                try:
                    on_durable(step)
                except BaseException as e:
                    self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


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
        # np.require keeps a 0-d leaf 0-d (ascontiguousarray makes it 1-d)
        t = torch.from_numpy(
            np.require(arr, requirements="C").view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        if str(arr.dtype) != want:
            raise ValueError(f"{path}: manifest says {want}, file holds "
                             f"{arr.dtype}")
        t = torch.from_numpy(np.require(arr, requirements="C"))
    if list(t.shape) != list(meta["shape"]):
        raise ValueError(f"{path}: manifest shape {meta['shape']}, file "
                         f"holds {list(t.shape)}")
    return t


def restore(root: str, step: Optional[int] = None, *,
            template: Dict[str, Any]) -> Tuple[Any, dict]:
    """Restore ``(tree, extra)`` of a committed step (default: the latest).

    ``template`` names the subtree to restore (see the module docstring);
    its leaves are found by key path among the saved tree's, from the
    manifest's ``keypaths`` (the port's saves) or its decoded ``treedef``
    (the reference's).  Raises ``ValueError`` when a template path is not
    in the checkpoint, or a leaf's dtype or shape disagrees with the
    manifest or the template."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints under {root}")
    path, manifest = _read_manifest(root, step)
    metas = manifest["leaves"]
    saved = manifest.get("keypaths")
    if saved is None:
        if not manifest.get("treedef"):
            raise ValueError(f"{path}: the manifest has neither key paths "
                             "nor a treedef")
        saved = [_path_name(kp) for kp in
                 treedef_keypaths(manifest["treedef"])]
    if len(saved) != len(metas):
        raise ValueError(f"{path} holds {len(metas)} leaves; its tree "
                         f"names {len(saved)}")
    index = {name: i for i, name in enumerate(saved)}
    slots = flatten(template)
    missing = [key for key, _ in slots if key not in index]
    if missing:
        raise ValueError(f"{path}: key paths of the template are not in the "
                         f"checkpoint: {missing[:3]}"
                         f"{' ...' if len(missing) > 3 else ''} "
                         f"({len(missing)} of {len(slots)} missing)")
    leaves = []
    for key, want in slots:
        i = index[key]
        meta = metas[i]
        if want is not None and list(want) != list(meta["shape"]):
            raise ValueError(f"{path}: leaf {key} has shape {meta['shape']},"
                             f" the template expects {list(want)}")
        leaves.append(_load_leaf(os.path.join(path, "arrays", f"{i:05d}.npy"),
                                 meta))
    return _unflatten(template, leaves), manifest.get("extra", {})


def gc_checkpoints(root: str, keep_last: int = 0,
                   protect: Iterable[int] = (), *,
                   keep: Optional[Iterable[int]] = None,
                   horizon: Optional[int] = None) -> List[int]:
    """Delete old committed checkpoints, never touching ``protect`` steps
    (checkpoints the validator has not finished).  Returns the deleted steps.

    Two retention shapes, as the reference's ``gc_checkpoints``:
      * recency window (default): keep the last ``keep_last`` steps
        (``keep_last == 0`` keeps everything);
      * explicit set: ``keep`` names exactly the steps to retain
        (``protect`` still applies on top).

    ``horizon`` (keep mode only) is the newest step the caller knew about
    when it computed ``keep`` / ``protect``: a checkpoint committed after
    it (step > horizon) survives this round.  It defaults to
    ``max(keep | protect)``; an empty decision deletes nothing.
    """
    steps = list_steps(root)
    protected = set(protect)
    if keep is not None:
        keep_set = set(keep) | protected
        if horizon is None:
            horizon = max(keep_set) if keep_set else None
        candidates = [] if horizon is None else \
            [s for s in steps if s not in keep_set and s <= horizon]
    elif keep_last > 0:
        candidates = [s for s in steps[:-keep_last] if s not in protected]
    else:
        candidates = []
    for s in candidates:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)
    return candidates
