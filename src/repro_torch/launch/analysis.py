"""Roofline terms of a launch step, counted on the meta device
(``repro/launch/analysis.py``).

The reference reads a compiled XLA program: ``cost_analysis()`` for flops
and bytes, the optimized HLO text for collective wire bytes and a
fusion-adjusted byte estimate, ``memory_analysis()`` for memory.  Eager
PyTorch compiles no program, so :func:`measure` runs the step itself, on
meta tensors (``launch/steps.py``'s ``abstract_args``: shapes and dtypes,
no data), and counts what it dispatches:

  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` (the products:
    mm, bmm, addmm, baddbmm, ...), forward and backward;
  * ``bytes_accessed``: every aten op's input and output bytes, views
    excluded — the unfused count, as XLA:CPU's;
  * ``hbm_bytes_est``: the result bytes of the ops whose results cross
    device memory even in a fused program (the aten counterparts of the
    reference's ``_HBM_BOUNDARY_OPS``: products, gathers, scatters, sorts,
    reductions, copies, concatenations, materialising ``contiguous``);
  * the peak of live intermediates (storages the step made, outputs
    excluded), from a liveness count of meta storages.

Divergences by design: the counts are of the whole (global) step, and the
per-device numbers divide them by the device count (``"split":
"ideal"``), since the port compiles no per-device SPMD program; per-device
argument, output and alias bytes are exact from the step's layouts.  There
is no HLO text, so ``parse_collectives`` and ``fusion_adjusted_bytes`` have
no counterpart: ``coll_wire_bytes`` and ``collective_s`` are ``None`` and
the bottleneck is picked from compute and memory.  The hardware is a
:class:`HardwareModel`; :func:`h100_sxm` holds the H100 SXM5 80GB
data-sheet peaks.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.core import pytree


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """One device's peaks: dense flop/s by operand type, memory and link
    bytes/s."""

    name: str
    peak_flops: float            # bf16 (and fp16) dense, flop/s
    peak_tf32: float
    peak_f32: float              # outside the tensor cores
    hbm_bw: float                # bytes/s
    link_bw: float               # bytes/s per direction

    def peak_for(self, dtype: torch.dtype) -> float:
        """The peak flop/s of products of ``dtype`` operands."""
        if dtype in (torch.bfloat16, torch.float16):
            return self.peak_flops
        return self.peak_f32


def h100_sxm() -> HardwareModel:
    """NVIDIA H100 SXM5 80GB, data sheet (dense, 700 W): bf16 989.4 TFLOP/s,
    TF32 494.7, f32 66.9, HBM3 3.35 TB/s, NVLink 4 450 GB/s a direction."""
    return HardwareModel(name="NVIDIA H100 SXM5 80GB", peak_flops=989.4e12,
                         peak_tf32=494.7e12, peak_f32=66.9e12,
                         hbm_bw=3.35e12, link_bw=450e9)


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group: int
    wire_bytes: float      # per-device, ring algorithm

    def as_dict(self):
        return dataclasses.asdict(self)


def _wire_bytes(kind: str, result_bytes: int, g: int) -> float:
    """Per-device wire traffic under ring algorithms."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * result_bytes
    if kind == "all-gather":
        return (g - 1) / g * result_bytes            # result = g x shard
    if kind == "reduce-scatter":
        return (g - 1) * result_bytes                # operand = g x result
    if kind == "all-to-all":
        return (g - 1) / g * result_bytes
    if kind == "collective-permute":
        return float(result_bytes)                   # one hop send+recv
    return 0.0


def _add(a: Optional[float], b: Optional[float], scale: float = 1.0):
    return None if a is None or b is None else a + scale * b


@dataclasses.dataclass
class Measurement:
    """Per-device cost numbers of one step.  ``coll_wire_bytes`` is None
    when the source has no collectives to read (the port's meta count);
    ``compute_typed_s`` is the products' time at each operand type's peak,
    ``memory`` the per-device memory breakdown."""
    flops: float
    bytes_accessed: float
    coll_wire_bytes: Optional[float]
    coll_ops: List[Dict[str, Any]]
    hbm_bytes_est: float = 0.0
    peak_memory_bytes: Optional[float] = None
    compute_typed_s: Optional[float] = None
    memory: Dict[str, float] = dataclasses.field(default_factory=dict)

    def combine(self, other: "Measurement", scale: float) -> "Measurement":
        """self + scale * other (for per-layer extrapolation)."""
        return Measurement(
            flops=self.flops + scale * other.flops,
            bytes_accessed=self.bytes_accessed + scale * other.bytes_accessed,
            coll_wire_bytes=_add(self.coll_wire_bytes, other.coll_wire_bytes,
                                 scale),
            coll_ops=self.coll_ops,
            hbm_bytes_est=self.hbm_bytes_est + scale * other.hbm_bytes_est,
            compute_typed_s=_add(self.compute_typed_s, other.compute_typed_s,
                                 scale),
        )

    @staticmethod
    def delta(q2: "Measurement", q1: "Measurement") -> "Measurement":
        def pos(a, b):
            return None if a is None or b is None else max(0.0, a - b)

        return Measurement(
            flops=max(0.0, q2.flops - q1.flops),
            bytes_accessed=max(0.0, q2.bytes_accessed - q1.bytes_accessed),
            coll_wire_bytes=pos(q2.coll_wire_bytes, q1.coll_wire_bytes),
            coll_ops=[],
            hbm_bytes_est=max(0.0, q2.hbm_bytes_est - q1.hbm_bytes_est),
            compute_typed_s=pos(q2.compute_typed_s, q1.compute_typed_s),
        )


def extrapolate(q1: Measurement, q2: Optional[Measurement],
                n_scaled: int) -> Measurement:
    """Q_full = Q1 + (n_scaled - 1) * (Q2 - Q1); Q2=None -> Q1."""
    if q2 is None or n_scaled <= 1:
        return q1
    return q1.combine(Measurement.delta(q2, q1), float(n_scaled - 1))


def roofline(m: Measurement, model_flops_per_dev: float,
             hw: HardwareModel) -> Dict[str, Any]:
    """The reference's roofline terms at ``hw``'s bf16 peak and memory
    rate; ``collective_s`` is None without collective bytes, and the
    bottleneck is then the larger of compute and memory."""
    compute_s = m.flops / hw.peak_flops
    memory_raw_s = m.bytes_accessed / hw.hbm_bw          # unfused bytes
    memory_s = m.hbm_bytes_est / hw.hbm_bw               # boundary bytes
    coll_s = (None if m.coll_wire_bytes is None
              else m.coll_wire_bytes / hw.link_bw)
    terms = [(compute_s, "compute"), (memory_s, "memory")]
    if coll_s is not None:
        terms.append((coll_s, "collective"))
    step_s, bound = max(terms)
    out = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "memory_raw_s": memory_raw_s,
        "collective_s": coll_s,
        "bottleneck": bound,
        "step_time_s": step_s,                      # no-overlap bound
        "model_flops_per_dev": model_flops_per_dev,
        "useful_flops_frac": (model_flops_per_dev / m.flops
                              if m.flops > 0 else 0.0),
        "roofline_frac": (model_flops_per_dev / hw.peak_flops / step_s
                          if step_s > 0 else 0.0),
    }
    if m.compute_typed_s is not None:
        # each product at its operand type's peak (f32 outside the tensor
        # cores), the bytes as above
        out["compute_typed_s"] = m.compute_typed_s
        out["step_time_typed_s"] = max(m.compute_typed_s, memory_s)
    return out


# ---------------------------------------------------------------------------
# Counting a step on the meta device
# ---------------------------------------------------------------------------

# ops whose results cross device memory in a fused program: products,
# gathers and scatters, sorts, reductions, copies and concatenations
_BOUNDARY_OPS = frozenset((
    "mm", "addmm", "bmm", "baddbmm", "_scaled_mm",
    "gather", "index", "embedding", "index_select", "take",
    "embedding_dense_backward",
    "scatter", "scatter_add", "scatter_reduce", "index_put", "index_put_",
    "_index_put_impl_", "index_add", "index_add_",
    "sort", "topk",
    "sum", "mean", "amax", "amin", "max", "min", "logsumexp",
    "linalg_vector_norm", "norm", "var", "std", "var_mean", "prod", "any",
    "all", "argmax", "argmin", "cumsum", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data",
    "segment_reduce", "_segment_reduce_backward",
    "copy", "copy_", "clone", "cat"))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results, in order (tuples,
    lists and dict values; ops take no deeper trees)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


class _Counter(TorchDispatchMode):
    """Counts each dispatched aten op's bytes and the liveness of the
    storages the step makes (keyed by their ``StorageImpl``; a storage
    lives while any tensor over it does)."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.hbm_bytes = 0
        self._refs: Dict[int, int] = {}
        self._sizes: Dict[int, int] = {}
        self.live = 0
        self.peak = 0
        # products' flops by the dtype of their first operand, from the
        # formulas FlopCounterMode counts with
        self.flops_by_dtype: Dict[torch.dtype, float] = {}

    def _release(self, key: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= self._sizes.pop(key)

    def _hold(self, t: torch.Tensor, new: bool) -> None:
        key = t.untyped_storage()._cdata
        if key not in self._refs:
            if not new:
                return                  # a view of something not made here
            self._refs[key] = 0
            self._sizes[key] = t.untyped_storage().nbytes()
            self.live += self._sizes[key]
            self.peak = max(self.peak, self.live)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key)

    def made(self, t: torch.Tensor) -> bool:
        """Whether ``t``'s storage was made by the counted step."""
        return t.untyped_storage()._cdata in self._refs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        alias = [r.alias_info for r in func._schema.returns]
        if any(a is not None and not a.is_write for a in alias):
            for t in _tensors(out):     # a view: no bytes, same storage
                self._hold(t, new=False)
            return out
        outs = _tensors(out)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            dt = _tensors(args)[0].dtype
            self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0) \
                + formula(*args, **(kwargs or {}), out_val=out)
        moved = sum(_nbytes(t) for t in _tensors((args, kwargs))) \
            + sum(_nbytes(t) for t in outs)
        self.bytes_accessed += moved
        if func._schema.name.split("::")[-1] in _BOUNDARY_OPS:
            self.hbm_bytes += sum(_nbytes(t) for t in outs)
        if not any(a is not None for a in alias):   # fresh results
            for t in outs:
                self._hold(t, new=True)
        return out


def _placed_bytes(tree, shardings) -> int:
    """One device's bytes of the tensors of ``tree`` laid out by
    ``shardings``, a tree that may stop at a prefix of ``tree`` (a
    NamedSharding covers the whole subtree; None: replicated)."""
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        if shardings is None:
            return _nbytes(tree)
        return math.prod(shardings.shard_shape(tree.shape)) \
            * tree.element_size()
    if shardings is None or not isinstance(shardings, (dict, list, tuple)):
        return sum(_placed_bytes(t, shardings)
                   for t in pytree.tree_leaves(tree))
    if isinstance(tree, dict):
        return sum(_placed_bytes(tree[k], shardings.get(k)) for k in tree)
    return sum(_placed_bytes(t, s) for t, s in zip(tree, shardings))


def measure(spec, world: int, hw: HardwareModel) -> Measurement:
    """Run ``spec.fn(*spec.abstract_args)`` (meta tensors) and count it:
    the step's global flops, bytes and boundary bytes divided by ``world``
    (the ideal split), ``compute_typed_s`` at ``hw``'s peak for each
    product's operand type, and the per-device memory from the layouts
    (arguments, outputs, donated arguments as aliases) plus the peak of
    live intermediates over ``world``."""
    counter = _Counter()
    flops = FlopCounterMode(display=False)
    with flops, counter:
        out = spec.fn(*spec.abstract_args)
    total_flops = float(flops.get_total_flops())
    outs = _tensors(out)
    made_out = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in outs if counter.made(t)}
    temp_global = max(0, counter.peak - sum(made_out.values()))
    args = _placed_bytes(spec.abstract_args, spec.in_shardings)
    outb = _placed_bytes(out, spec.out_shardings)
    alias = sum(_placed_bytes(spec.abstract_args[i], spec.in_shardings[i])
                for i in spec.donate_argnums)
    temp = temp_global / world
    memory = {"argument_size_in_bytes": float(args),
              "output_size_in_bytes": float(outb),
              "temp_size_in_bytes": float(temp),
              "alias_size_in_bytes": float(alias),
              "temp_global_bytes": float(temp_global)}
    memory["per_device_total"] = float(args + outb + temp - alias)
    typed = sum(f / hw.peak_for(dt)
                for dt, f in counter.flops_by_dtype.items())
    del out, outs
    return Measurement(
        flops=total_flops / world,
        bytes_accessed=float(counter.bytes_accessed) / world,
        coll_wire_bytes=None, coll_ops=[],
        hbm_bytes_est=float(counter.hbm_bytes) / world,
        peak_memory_bytes=memory["per_device_total"],
        compute_typed_s=typed / world, memory=memory)
