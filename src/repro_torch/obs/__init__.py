"""Observability — lifecycle span tracing and a process metrics registry
(the port's copy of ``repro/obs``, which it does not import).

The single entry point is :class:`Telemetry`: a nullable handle threaded
through the trainer, watcher, suite, engines and validator.  Every
instrumentation site follows one pattern::

    tel = self.telemetry
    if tel is not None:
        tel.event("discovered", step=step)

so *disabled* telemetry (the default — every constructor defaults to
``telemetry=None``) costs one attribute check and one ``is not None``
branch per site, writes no files, and leaves ledgers and event logs
byte-identical.  Enabled telemetry writes spans to its own trace file
(never to any ledger) and aggregates metrics in memory; nothing it
produces is ever read back by a scheduling, claim, or selection decision.

A ``Telemetry`` can be metrics-only (``trace_path=None``): the registry
aggregates latencies for ``--obs_report`` without any span file I/O.
``mark``/``since`` provide cross-stage latency measurement (e.g.
checkpoint discovery → verdict recorded) keyed on arbitrary tuples.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Optional

from repro_torch.obs.device import DeviceClock
from repro_torch.obs.metrics import (Counter, Ewma, Gauge, Histogram,
                               MetricsRegistry)
from repro_torch.obs.trace import (LIFECYCLE_STAGES, SpanTracer, read_trace,
                                   to_time_ns)

__all__ = ["Telemetry", "MetricsRegistry", "SpanTracer", "read_trace",
           "to_time_ns", "DeviceClock", "LIFECYCLE_STAGES", "Counter",
           "Gauge", "Ewma", "Histogram"]

_NULL_CM = contextlib.nullcontext()


class Telemetry:
    """Tracer + metrics registry + cross-stage marks, behind one handle.

    Parameters
    ----------
    trace_path:
        JSONL trace file for lifecycle spans; ``None`` for metrics-only.
    registry:
        Share an existing :class:`MetricsRegistry` (e.g. between a
        validator and its watcher policy); a fresh one is created if
        omitted.
    process / attrs:
        Tracer identity: ``process`` labels this process's timeline track
        and ``attrs`` (e.g. ``{"worker_id": "w0"}``) are stamped on every
        span/event the tracer writes.
    """

    def __init__(self, trace_path: Optional[str] = None, *,
                 registry: Optional[MetricsRegistry] = None,
                 process: Optional[str] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.tracer: Optional[SpanTracer] = (
            SpanTracer(trace_path, process=process, attrs=attrs)
            if trace_path else None)
        self._marks: Dict[Any, float] = {}
        self._marks_lock = threading.Lock()

    # -- tracing ------------------------------------------------------------
    def span(self, name: str, **attrs: Any):
        """Context manager for a lifecycle span (no-op without a tracer)."""
        tracer = self.tracer
        return _NULL_CM if tracer is None else tracer.span(name, **attrs)

    def event(self, name: str, **attrs: Any) -> None:
        tracer = self.tracer
        if tracer is not None:
            tracer.event(name, **attrs)

    def record(self, name: str, t0: float, dur: float, **attrs: Any
               ) -> Optional[int]:
        """A span from explicit monotonic ``t0``/``dur``; its id, or None
        without a tracer.  ``parent=<id>`` (``None``: top level) nests it
        under a span other than the one open on this thread."""
        tracer = self.tracer
        if tracer is not None:
            return tracer.record(name, t0, dur, **attrs)
        return None

    def flush(self) -> None:
        tracer = self.tracer
        if tracer is not None:
            tracer.flush()

    # -- cross-stage latency marks ------------------------------------------
    def mark(self, name: str, key: Any) -> None:
        """Remember *now* (monotonic) under ``(name, key)``."""
        with self._marks_lock:
            self._marks[(name, key)] = time.monotonic()

    def since(self, name: str, key: Any, *, pop: bool = False
              ) -> Optional[float]:
        """Seconds since :meth:`mark`, or ``None`` if never marked (e.g.
        the mark lives in another fleet process)."""
        with self._marks_lock:
            t0 = (self._marks.pop((name, key), None) if pop
                  else self._marks.get((name, key)))
        return None if t0 is None else time.monotonic() - t0
