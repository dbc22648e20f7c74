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
    staged     -> host->device staging wait inside one engine run (span)
    encoded    -> query tower encode (span)
    scored     -> one full engine run for one (step, task) unit (span)
    recorded   -> ledger append of the verdict rows (span)
    selected   -> control plane changed its best-step choice (event)
    promoted   -> serving promoter built+verified+installed an index (span)
    served     -> one answered query micro-batch (span)

Trace-record schema (one JSON object per line, mirroring the workqueue
claim-record docs)::

    {"kind": "span",  "name": "scored", "id": 7, "parent": 3,
     "t0": 1234.567890, "dur": 0.0123, "pid": 4242, "tid": 139823,
     "process": "worker-0", ...attrs}
    {"kind": "event", "name": "discovered", "id": 8, "parent": null,
     "t": 1234.560000, "pid": 4242, "tid": 139823,
     "process": "worker-0", ...attrs}

* ``t0`` / ``t`` / ``dur`` are **``time.monotonic()`` seconds**.  On Linux
  that clock is CLOCK_MONOTONIC, which is system-wide: trace files written
  by different fleet worker processes on one host share a timebase, so the
  exporter can merge them into a single timeline without skew correction.
  Monotonic time has an arbitrary epoch — compare within a host/boot only.
* ``id`` is unique within one trace file; ``parent`` is the ``id`` of the
  innermost span open *on the same thread* when the record was created
  (``null`` at top level).  Nesting is tracked with a thread-local stack,
  so spans opened on different threads never accidentally adopt each
  other.
* ``process`` and any extra attributes (``worker_id``, ``step``, ``task``,
  ``engine``, ``score_dtype``, ...) are flat top-level keys.  Default
  attributes passed to the tracer (e.g. the fleet worker id) are stamped
  on every record.

Writes go through :func:`repro_torch.core.jsonl.append_jsonl_atomic` —
the same O_APPEND + single-``write`` + fsync discipline as the validation
ledger — so a crashed worker leaves at most one torn tail line, which the
tolerant reader (and the exporter) skips.  Records are buffered in memory and
flushed every ``flush_every`` records, on :meth:`SpanTracer.flush`, and at
interpreter exit; buffering keeps the per-span cost to a dict append
rather than an fsync.

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

__all__ = ["SpanTracer", "read_trace", "LIFECYCLE_STAGES"]

#: canonical hand-off order; the exporter sorts same-timestamp records by it
LIFECYCLE_STAGES: Tuple[str, ...] = (
    "produced", "snapshotted", "discovered", "published", "claimed",
    "store_build", "staged", "encoded", "scored", "recorded", "selected",
    "promoted", "served")


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
        self._buf: List[Dict[str, Any]] = []
        self._ids = 0
        self._tls = threading.local()
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
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
        with self._lock:
            self._buf.append(rec)
            should_flush = len(self._buf) >= self.flush_every
        if should_flush:
            self.flush()

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

    def record(self, name: str, t0: float, dur: float, **attrs: Any) -> None:
        """Record a span post-hoc from explicit monotonic ``t0``/``dur``
        (for hot loops that accumulate timings and emit once).  The parent
        is whatever span is currently open on this thread."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        self._emit("span", name, self._next_id(), parent,
                   {"t0": float(t0), "dur": float(dur)}, attrs)

    def flush(self) -> None:
        with self._lock:
            buf, self._buf = self._buf, []
        if buf:
            append_jsonl_atomic(self.path, buf)

    def close(self) -> None:
        self.flush()


def read_trace(path: str) -> List[Dict[str, Any]]:
    """Read one trace file, skipping a torn tail line if present."""
    records, _ = read_jsonl_tolerant(path, kind="trace record")
    return records
