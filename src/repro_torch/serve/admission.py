"""Admission control — overload degrades by rejection, never by queueing
(``repro/serve/admission.py``).

A serving tier with an unbounded request queue converts overload into
unbounded latency (every queued request eventually answers, seconds late).
The controller caps in-flight requests instead: beyond ``max_pending`` a
submit fails fast with :class:`ServeOverloaded` and the client retries
against fresher state.  Counters are plain observability — a zero-drop
gate reads ``rejected`` to prove the hot-swap path never sheds load
(``chip_smoke.py``'s hot-swap part sizes ``max_pending`` above its
offered concurrency, so any rejection there means a real blackout, not
admission working).
"""

from __future__ import annotations

import threading


class ServeOverloaded(RuntimeError):
    """Raised by submits past the in-flight bound; safe to retry later."""


class AdmissionController:
    """Bounded in-flight request counter (thread-safe)."""

    def __init__(self, max_pending: int = 256):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = int(max_pending)
        self._lock = threading.Lock()
        self.pending = 0
        self.peak = 0
        self.admitted = 0
        self.rejected = 0
        self._reject_counter = None     # repro_torch.obs Counter, when bound

    def bind_metrics(self, registry) -> None:
        """Mirror rejections into ``serve.admission_rejects`` on a shared
        :class:`repro_torch.obs.MetricsRegistry` (counting any pre-bind ones)."""
        counter = registry.counter("serve.admission_rejects")
        with self._lock:
            if self.rejected:
                counter.inc(self.rejected)
            self._reject_counter = counter

    def try_acquire(self) -> bool:
        with self._lock:
            if self.pending >= self.max_pending:
                self.rejected += 1
                if self._reject_counter is not None:
                    self._reject_counter.inc()
                return False
            self.pending += 1
            self.admitted += 1
            self.peak = max(self.peak, self.pending)
            return True

    def release(self) -> None:
        with self._lock:
            if self.pending <= 0:
                raise RuntimeError("release() without a matching acquire")
            self.pending -= 1
