"""Span tracer — the checkpoint lifecycle as an append-only JSONL trace.

Every stage a checkpoint moves through, from the trainer's fsync to a
served query batch, is recorded as a *span* (an interval) or an *event*
(an instant) in a per-process trace file.  The lifecycle vocabulary, in
hand-off order::

    produced   -> trainer committed the checkpoint (event)
    snapshotted-> hand-off channel published a pre-durable host snapshot
                  (event; absent on the classic durable-only path)
    discovered -> watcher saw the COMMIT marker (event)
    published  -> fleet queue exposed a (step, task) unit (event)
    claimed    -> a worker won the claim race for a unit (event)
    store_build-> TokenStore padding/commit (span)
    staged     -> the wait for one staged host->device batch (span, one a
                  schedule entry: a chunk, or a window of chunks)
    encoded    -> query tower encode; ``role="corpus"``: the streaming
                  engine's whole encode-and-fold loop (span)
    scored     -> one full engine run for one (step, task) unit (span)
    recorded   -> ledger append of the verdict rows (span)
    selected   -> control plane changed its best-step choice (event)
    promoted   -> serving promoter built+verified+installed an index (span)
    served     -> one answered query micro-batch (span)

Spans of the layers inside those stages, outside the lifecycle order::

    restored   -> the validator's host read of a checkpoint's leaves
    uploaded   -> the streaming engine's host->device upload of the params
    chunk      -> one corpus chunk's encode and fold (device intervals)
    queued     -> one query's wait from its submit to its batch's dispatch
    topk       -> one ``ServingIndex.topk`` call of a served batch

Trace-record schema (one JSON object per line, mirroring the workqueue
claim-record docs)::

    {"kind": "span",  "name": "scored", "id": 7, "parent": 3,
     "t0": 1234.567890, "dur": 0.0123, "pid": 4242, "tid": 139823,
     "process": "worker-0", ...attrs}
    {"kind": "event", "name": "discovered", "id": 8, "parent": null,
     "t": 1234.560000, "pid": 4242, "tid": 139823,
     "process": "worker-0", ...attrs}
    {"kind": "clock", "name": "clock", "monotonic": 1234.500000,
     "time_ns": 1760784000123456789, "pid": 4242, "tid": 139823,
     "process": "worker-0", ...default attrs}

* ``t0`` / ``t`` / ``dur`` are **``time.monotonic()`` seconds**.  On Linux
  that clock is CLOCK_MONOTONIC, which is system-wide: trace files written
  by different fleet worker processes on one host share a timebase, so the
  exporter can merge them into a single timeline without skew correction.
  Monotonic time has an arbitrary epoch — compare within a host/boot only.
* ``id`` is unique within one trace file; ``parent`` is the ``id`` of the
  innermost span open *on the same thread* when the record was created
  (``null`` at top level), or the one :meth:`SpanTracer.record` is
  given.  Nesting is tracked with a thread-local stack, so spans opened
  on different threads never accidentally adopt each other.
* ``process`` and any extra attributes (``worker_id``, ``step``, ``task``,
  ``engine``, ``score_dtype``, ...) are flat top-level keys.  Default
  attributes passed to the tracer (e.g. the fleet worker id) are stamped
  on every record.

Clocks.  Besides spans and events the tracer writes ``clock`` records, a
``monotonic`` and a ``time_ns`` (``time.time_ns()``) reading taken back
to back, one when it is created and one with every write, so a reader
can put any span on the wall clock that ``torch.profiler`` stamps its
events with (:func:`to_time_ns`).  :func:`read_trace` leaves them out;
``read_trace(path, clocks=True)`` keeps them.  Device intervals
(``dev_t0`` / ``dev_s`` and the ``trunk_s`` / ``fold_s`` split of a
``chunk``) are CUDA events on the working stream, put on the same
monotonic clock through one anchor event recorded right after a
synchronize of that stream, when the event runs as it is recorded
(:class:`repro_torch.obs.device.DeviceClock`).  On CPU tensors a device
interval is the host interval.

Writes.  Emitting a record only appends it to an in-memory buffer: no
thread that emits a span ever touches a file.  The buffer goes out
through :func:`repro_torch.core.jsonl.append_jsonl_atomic` (the ledger's
O_APPEND + single-``write`` + fsync discipline, so a crashed worker
leaves at most one torn tail line, which the tolerant reader skips) on
:meth:`SpanTracer.flush` and :meth:`SpanTracer.close`, at interpreter
exit, and, once ``flush_every`` records wait, on a writer thread of the
tracer's own.  :meth:`~SpanTracer.flush` is synchronous: every record
emitted before it is in the file when it returns.

Nothing on a query's path.  A site that traces work a caller waits for
(a served query) takes clock readings and records CUDA events while the
work runs, and emits its spans only after the answers are released:
never a synchronize, an event query or a file write on the way.

The tracer **observes, never participates**: nothing in this module is
read back by any scheduling, claim, or selection decision, and the
decision folds (``workqueue.replay``, ``control.plane.replay_ledger``)
remain clock-free.  Disabled telemetry (``Telemetry.tracer is None``)
costs exactly one attribute check at each instrumentation site.
"""

from __future__ import annotations

import atexit
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.jsonl import append_jsonl_atomic, read_jsonl_tolerant

__all__ = ["SpanTracer", "read_trace", "to_time_ns", "LIFECYCLE_STAGES"]

#: canonical hand-off order; the exporter sorts same-timestamp records by it
LIFECYCLE_STAGES: Tuple[str, ...] = (
    "produced", "snapshotted", "discovered", "published", "claimed",
    "store_build", "staged", "encoded", "scored", "recorded", "selected",
    "promoted", "served")


#: :meth:`SpanTracer.record`'s default: the parent is the open span
_FROM_STACK = object()


class _Span:
    """Context manager handle; returned by :meth:`SpanTracer.span`."""

    __slots__ = ("tracer", "name", "attrs", "id", "t0")

    def __init__(self, tracer: "SpanTracer", name: str,
                 attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.id: Optional[int] = None
        self.t0 = 0.0

    def __enter__(self) -> "_Span":
        self.id = self.tracer._next_id()
        self.tracer._stack().append(self.id)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = time.monotonic() - self.t0
        stack = self.tracer._stack()
        stack.pop()
        parent = stack[-1] if stack else None
        if exc_type is not None:
            self.attrs = dict(self.attrs, error=repr(exc))
        self.tracer._emit("span", self.name, self.id, parent,
                          {"t0": self.t0, "dur": dur}, self.attrs)


class SpanTracer:
    """Buffered lifecycle tracer writing one JSONL trace file.

    Thread-safe: the record buffer and id counter are lock-protected and
    the open-span stack is thread-local.  One tracer per process (or per
    simulated worker in tests) is the intended granularity.
    """

    def __init__(self, path: str, *, process: Optional[str] = None,
                 attrs: Optional[Dict[str, Any]] = None,
                 flush_every: int = 128):
        self.path = str(path)
        self.process = process if process is not None \
            else f"pid-{os.getpid()}"
        self.default_attrs = dict(attrs or {})
        self.flush_every = max(1, int(flush_every))
        self._lock = threading.Lock()
        # one write at a time, in buffer order: flush() waits for the
        # writer thread's write in progress
        self._write_lock = threading.Lock()
        self._buf: List[Dict[str, Any]] = []
        self._ids = 0
        self._tls = threading.local()
        self._wake = threading.Event()
        self._writer: Optional[threading.Thread] = None
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._buf.append(self._clock())
        atexit.register(self.flush)

    # -- internals ----------------------------------------------------------
    def _stack(self) -> List[int]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _next_id(self) -> int:
        with self._lock:
            self._ids += 1
            return self._ids

    def _clock(self) -> Dict[str, Any]:
        """A ``clock`` record: the monotonic reading is the midpoint of
        two taken around the ``time_ns`` one, the tightest of three such
        brackets (a thread preempted inside one widens it)."""
        best = None
        for _ in range(3):
            m0 = time.monotonic()
            ns = time.time_ns()
            m1 = time.monotonic()
            if best is None or m1 - m0 < best[0]:
                best = (m1 - m0, 0.5 * (m0 + m1), ns)
        rec: Dict[str, Any] = {"kind": "clock", "name": "clock",
                               "monotonic": best[1], "time_ns": best[2],
                               "pid": os.getpid(),
                               "tid": threading.get_ident(),
                               "process": self.process}
        for k, v in self.default_attrs.items():
            rec.setdefault(k, v)
        return rec

    def _emit(self, kind: str, name: str, rec_id: Optional[int],
              parent: Optional[int], times: Dict[str, float],
              attrs: Dict[str, Any]) -> None:
        rec: Dict[str, Any] = {"kind": kind, "name": name, "id": rec_id,
                               "parent": parent}
        rec.update(times)
        rec["pid"] = os.getpid()
        rec["tid"] = threading.get_ident()
        rec["process"] = self.process
        for k, v in self.default_attrs.items():
            rec.setdefault(k, v)
        for k, v in attrs.items():
            if v is not None:
                rec[k] = v
        writer = None
        with self._lock:
            self._buf.append(rec)
            full = len(self._buf) >= self.flush_every
            if full and self._writer is None:
                writer = self._writer = threading.Thread(
                    target=self._write_loop, name="span-writer", daemon=True)
        if writer is not None:
            writer.start()
        if full:
            self._wake.set()

    def _write_loop(self) -> None:
        """The writer thread: writes the buffer whenever ``flush_every``
        records wait, and ends after a quiet spell with nothing buffered
        (the next full buffer starts another)."""
        while True:
            woke = self._wake.wait(5.0)
            self._wake.clear()
            self.flush()
            if not woke:
                with self._lock:
                    if not self._buf:
                        self._writer = None
                        return

    # -- public API ---------------------------------------------------------
    def span(self, name: str, **attrs: Any) -> _Span:
        """Open a lifecycle span; use as a context manager."""
        return _Span(self, name, attrs)

    def event(self, name: str, **attrs: Any) -> None:
        """Record an instantaneous lifecycle event at *now*."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        self._emit("event", name, self._next_id(), parent,
                   {"t": time.monotonic()}, attrs)

    def record(self, name: str, t0: float, dur: float, *,
               parent: Any = _FROM_STACK, **attrs: Any) -> int:
        """Record a span post-hoc from explicit monotonic ``t0``/``dur``
        (for hot loops that accumulate timings and emit once) and return
        its id.  The parent is ``parent`` when given (``None``: top level),
        else whatever span is currently open on this thread."""
        if parent is _FROM_STACK:
            stack = self._stack()
            parent = stack[-1] if stack else None
        rec_id = self._next_id()
        self._emit("span", name, rec_id, parent,
                   {"t0": float(t0), "dur": float(dur)}, attrs)
        return rec_id

    def flush(self) -> None:
        """Write every buffered record, and a fresh ``clock`` record, to
        the trace file before returning."""
        with self._write_lock:
            with self._lock:
                buf, self._buf = self._buf, []
            if buf:
                buf.append(self._clock())
                append_jsonl_atomic(self.path, buf)

    def close(self) -> None:
        self.flush()


def read_trace(path: str, *, clocks: bool = False) -> List[Dict[str, Any]]:
    """Read one trace file, skipping a torn tail line if present: its
    spans and events, and its ``clock`` records too with ``clocks``."""
    records, _ = read_jsonl_tolerant(path, kind="trace record")
    return records if clocks else [r for r in records
                                   if r.get("kind") != "clock"]


def to_time_ns(t: float, clocks: List[Dict[str, Any]]) -> int:
    """Monotonic seconds ``t`` (a span's ``t0``, ``dev_t0``, ...) as
    ``time.time_ns()`` nanoseconds, the clock ``torch.profiler`` stamps
    events with, through the ``clock`` record of ``clocks`` nearest to
    ``t``."""
    c = min((r for r in clocks if r.get("kind") == "clock"),
            key=lambda r: abs(r["monotonic"] - t))
    return c["time_ns"] + round((t - c["monotonic"]) * 1e9)
