"""Placements and layouts on a :class:`~repro_torch.distributed.compat.
DeviceMesh`.

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

The reference's logical-axis rules engine is here too (``Rules``,
``spec_for``, ``tree_shardings``, ``opt_state_shardings``, the rule tables
``lm_train_rules`` / ``lm_serve_rules`` / ``fsdp_only_rules``,
``lm_batch_spec``, ``cache_spec``), with a :class:`PartitionSpec` and a
:class:`NamedSharding` of the port's own.  Each computes what its
reference counterpart computes: a mesh axis applies to a dim only if it
divides it, else the next candidate does (or none); the leftmost logical
axis that claims a mesh axis wins it; leading stack dims are never
sharded; optimizer slots inherit a param's spec by shape, Adafactor's
factored slots with the dropped dim removed.  A :class:`NamedSharding`
only *describes* a layout: the port places nothing by it.  The LM, GNN and
recsys steps of ``launch/steps.py`` run eager and unsharded, and the
mesh's sharded paths keep their own placements (:func:`rows_sharding`,
:func:`replicated_sharding`).  The dry run (``launch/dryrun.py``) reads the
specs to count per-device bytes.

A mesh of meta devices (``launch/mesh.py::make_production_mesh``) holds no
data: the placements raise when asked to put anything but a meta tensor on
it (:func:`~repro_torch.distributed.compat.check_placeable`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import pytree
from repro_torch.distributed.compat import DeviceMesh, check_placeable
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
        check_placeable(self.mesh, x)
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
        for leaf in pytree.tree_leaves(tree):
            check_placeable(self.mesh, leaf)
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


# ---------------------------------------------------------------------------
# Layouts: PartitionSpec, NamedSharding and the logical-axis rules engine
# ---------------------------------------------------------------------------

#: one entry of a spec: replicated, one mesh axis, or several jointly
SpecEntry = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per array dim, ``None``
    (replicated), a mesh axis name, or a tuple of names (the dim split over
    them jointly, the first major).  A one-name tuple becomes the name, as
    in ``P``, and trailing ``None`` entries are dropped, as the reference's
    builders drop them, so equal layouts compare equal."""

    def __new__(cls, *entries: SpecEntry):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                if len(e) == 1:
                    e = e[0]
            norm.append(e)
        while norm and norm[-1] is None:
            norm.pop()
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout: ``spec`` over the axes of ``mesh``.  Describes; places
    nothing."""

    mesh: DeviceMesh
    spec: PartitionSpec

    def shards_of(self, ndim: int) -> List[int]:
        """How many pieces each of ``ndim`` dims is split into."""
        out = [1] * ndim
        for d, entry in enumerate(self.spec):
            if entry is not None:
                out[d] = _axis_size(self.mesh, entry)
        return out

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """One device's block of an array of ``shape`` (dims rounded up,
        as a padded layout holds them)."""
        return tuple(-(-int(n) // k) for n, k in
                     zip(shape, self.shards_of(len(shape))))


# a rule value: mesh axis name, tuple of mesh axes (joint sharding), a
# priority list of candidates tried in order, or None (replicate).
AxisRule = Union[None, str, Tuple[str, ...],
                 Sequence[Union[str, Tuple[str, ...]]]]


@dataclasses.dataclass
class Rules:
    """Logical axis name -> mesh-axis rule (``default`` for names the table
    lacks)."""

    table: Dict[str, AxisRule]
    default: AxisRule = None

    def candidates(self, logical: str) -> list:
        """Normalized list of candidate mesh-axis assignments for one
        dim."""
        rule = self.table.get(logical, self.default)
        if rule is None:
            return []
        if isinstance(rule, (str, tuple)):
            return [rule]
        return list(rule)  # priority list


def _axis_size(mesh: DeviceMesh,
               assignment: Union[str, Tuple[str, ...]]) -> int:
    if isinstance(assignment, str):
        return mesh.shape[assignment]
    size = 1
    for a in assignment:
        size *= mesh.shape[a]
    return size


def spec_for(shape: Tuple[int, ...], axes: Tuple[str, ...], rules: Rules,
             mesh: DeviceMesh) -> PartitionSpec:
    """PartitionSpec of one array from its logical axes.  ``len(axes)`` may
    be smaller than ``len(shape)``: the extra *leading* dims are layer
    stacks and stay unsharded."""
    n_stack = len(shape) - len(axes)
    if n_stack < 0:
        raise ValueError(f"rank {len(shape)} < logical rank {len(axes)}")
    entries: list = [None] * n_stack
    used: set = set()
    for dim, logical in zip(shape[n_stack:], axes):
        chosen = None
        for cand in rules.candidates(logical):
            flat = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(a in used for a in flat):
                continue
            if dim % _axis_size(mesh, cand) != 0:
                continue
            chosen = cand
            used.update(flat)
            break
        entries.append(chosen)
    return PartitionSpec(*entries)


def _map_axes(fn, params: Any, axes: Any) -> Any:
    """``fn(leaf, axes)`` over a params tree of nested dicts and the
    matching axes tree, whose leaves are tuples of names."""
    if isinstance(params, dict):
        return {key: _map_axes(fn, params[key], axes[key]) for key in params}
    return fn(params, tuple(axes))


def tree_shardings(abstract_params: Any, axes_tree: Any, rules: Rules,
                   mesh: DeviceMesh) -> Any:
    """NamedSharding tree parallel to ``abstract_params`` (tensors, meta or
    not, or anything with a ``shape``), from ``axes_tree``, the matching
    logical-axes tree (``param_axes``)."""
    return _map_axes(lambda leaf, axes: NamedSharding(
        mesh, spec_for(tuple(leaf.shape), axes, rules, mesh)),
        abstract_params, axes_tree)


def opt_state_shardings(abstract_opt_state: Any, abstract_params: Any,
                        param_shardings: Any, mesh: DeviceMesh) -> Any:
    """Shardings for optimizer state by *shape matching* against params:
    same-shape slots (Adam m / v) take the param's spec (the first param of
    that shape in leaf order), factored slots (Adafactor vr / vc: the
    param's shape minus its last or second-to-last dim) take it with that
    dim removed, anything else (the step counter) is replicated."""
    flat_p = pytree.tree_leaves(abstract_params)
    flat_s = pytree.tree_leaves(param_shardings)
    by_shape: Dict[Tuple[int, ...], NamedSharding] = {}
    for p, s in zip(flat_p, flat_s):
        by_shape.setdefault(tuple(p.shape), s)
    factored: Dict[Tuple[int, ...], NamedSharding] = {}
    for p, s in zip(flat_p, flat_s):
        shape = tuple(p.shape)
        if len(shape) < 2:
            continue
        spec = list(s.spec) + [None] * (len(shape) - len(s.spec))
        for d in (len(shape) - 1, len(shape) - 2):   # adafactor drops -1 / -2
            red = shape[:d] + shape[d + 1:]
            factored.setdefault(red, NamedSharding(
                mesh, PartitionSpec(*(spec[:d] + spec[d + 1:]))))
    replicated = NamedSharding(mesh, PartitionSpec())

    def one(leaf):
        shape = tuple(leaf.shape)
        return by_shape.get(shape) or factored.get(shape) or replicated

    return pytree.tree_map(one, abstract_opt_state)


def lm_train_rules() -> Rules:
    """2-D sharding: TP on "model" (heads/mlp/vocab/experts), FSDP on
    "data"."""
    return Rules({
        "embed": ["data", "model"],     # FSDP; fall back to model if data ∤ dim
        "embed2": "data",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": ["model", "data"],
        "expert": "model",              # EP
        "kv_lora": "data",
        "table_rows": [("data", "model"), "data", "model"],
        "gnn_in": "data",
        "gnn_hidden": "model",
        "gnn_out": None,
        "pos": None, "seq": None, "interests": None,
    })


def lm_serve_rules() -> Rules:
    """Inference: TP on "model" (heads/mlp/vocab/experts) plus "data" on
    the embed dim (2-D weight sharding, the big-model serving layout)."""
    return Rules({
        "embed": "data",
        "embed2": None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": ["model", "data"],
        "expert": "model",
        "kv_lora": "data",
        "table_rows": [("data", "model"), "data", "model"],
        "gnn_in": None, "gnn_hidden": "model", "gnn_out": None,
        "pos": None, "seq": None, "interests": None,
    })


def fsdp_only_rules() -> Rules:
    """Pure ZeRO-3 over every mesh axis jointly (validator / encode meshes:
    encoding is data-parallel, so the weights need only fit)."""
    return Rules({}, default=[("data", "model"), "data", "model"])


def lm_batch_spec(mesh: DeviceMesh, global_batch: int) -> PartitionSpec:
    """Token batches: rows on the data-parallel axes when they divide the
    batch, else on "data", else replicated."""
    dp = batch_axes(mesh)
    if global_batch % _axis_size(mesh, dp) == 0:
        return PartitionSpec(dp)
    if global_batch % mesh.shape["data"] == 0:
        return PartitionSpec("data")
    return PartitionSpec()


def cache_spec(mesh: DeviceMesh, cache_shape: Tuple[int, ...], batch: int,
               *, seq_dim: int = 2, batch_dim: int = 1) -> PartitionSpec:
    """KV-cache layout: batch on the data-parallel axes, sequence on
    "model"; a batch that does not divide them gives the sequence the
    whole mesh (or "model" alone)."""
    dp = batch_axes(mesh)
    entries: list = [None] * len(cache_shape)
    T = cache_shape[seq_dim]
    if batch % _axis_size(mesh, dp) == 0:
        entries[batch_dim] = dp
        if T % mesh.shape["model"] == 0:
            entries[seq_dim] = "model"
    else:
        all_ax = tuple(a for a in ("pod", "data", "model")
                       if a in mesh.axis_names)
        if T % _axis_size(mesh, all_ax) == 0:
            entries[seq_dim] = all_ax
        elif T % mesh.shape["model"] == 0:
            entries[seq_dim] = "model"
    return PartitionSpec(*entries)
