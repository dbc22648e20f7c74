"""Metrics registry — counters, gauges, EMAs, and histograms, no deps.

One process-wide registry maps instrument *names* (dotted strings, e.g.
``"validate.ckpt_to_verdict_s"``) to instrument objects.  Instruments are
created on first use and shared thereafter: two subsystems asking for the
same name get the same object, which is exactly how the watcher's
:class:`~repro_torch.core.watcher.BudgetPolicy` and the validator share one
source of timing truth (the policy *reads* the EMA the validator *feeds*).

Design constraints, in priority order:

* **Zero dependencies.** Plain dicts, locks, and ``statistics``-free
  percentile math — the registry must import anywhere the repo does.
* **Cheap when idle.** An instrument that is never observed costs one dict
  entry; observation is a lock + float update.  Nothing here touches the
  clock — callers time things and hand in seconds.
* **Observe, never participate.** Registry state must not feed replayed
  decisions; it is rebuilt empty each process and is deliberately not
  persisted anywhere a decision fold could read it.

Instrument types
----------------
``Counter``    monotonically increasing int (``inc``).
``Gauge``      last-written float (``set``).
``Ewma``       exponential moving average with the repo's canonical
               update rule ``v if prev is None else s*prev + (1-s)*v``
               (bit-identical to the old private BudgetPolicy EMAs).
``Histogram``  count / total / min / max plus a bounded reservoir of the
               most recent observations for percentile queries.

Snapshots
---------
``snapshot()`` returns a plain-dict view (JSON-ready), ``dump(path)``
writes it as JSON, and ``render()`` produces the fixed-width text table
behind ``repro_torch.core.cli --obs_report``.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
from typing import Any, Dict, List, Optional

__all__ = ["Counter", "Gauge", "Ewma", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += int(n)

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-written value."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Ewma:
    """Exponential moving average; ``smooth`` is the weight on the *old*
    estimate, matching the BudgetPolicy convention (``smooth=0.0`` tracks
    the last observation exactly)."""

    __slots__ = ("name", "smooth", "value", "count", "_lock")

    def __init__(self, name: str, smooth: float = 0.5):
        self.name = name
        self.smooth = float(smooth)
        self.value: Optional[float] = None
        self.count = 0
        self._lock = threading.Lock()

    def update(self, v: float) -> None:
        v = float(v)
        with self._lock:
            prev = self.value
            self.value = v if prev is None \
                else self.smooth * prev + (1.0 - self.smooth) * v
            self.count += 1

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "ewma", "value": self.value, "count": self.count,
                "smooth": self.smooth}


class Histogram:
    """Count/total/min/max plus a bounded reservoir of recent observations
    (newest ``maxlen`` values) for percentile queries.  The reservoir bound
    keeps a long-running fleet's memory flat; percentiles are therefore
    over the recent window, which is what an operator wants anyway."""

    __slots__ = ("name", "count", "total", "vmin", "vmax", "_values", "_lock")

    def __init__(self, name: str, maxlen: int = 2048):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self._values: collections.deque = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.vmin = v if self.vmin is None else min(self.vmin, v)
            self.vmax = v if self.vmax is None else max(self.vmax, v)
            self._values.append(v)

    @property
    def mean(self) -> Optional[float]:
        return (self.total / self.count) if self.count else None

    def percentile(self, p: float) -> Optional[float]:
        """Nearest-rank percentile over the retained reservoir."""
        with self._lock:
            vals = sorted(self._values)
        if not vals:
            return None
        rank = max(1, int(math.ceil(p / 100.0 * len(vals))))
        return vals[min(rank, len(vals)) - 1]

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "histogram", "count": self.count, "total": self.total,
                "mean": self.mean, "min": self.vmin, "max": self.vmax,
                "p50": self.percentile(50), "p99": self.percentile(99)}


class MetricsRegistry:
    """Thread-safe name → instrument map with create-on-first-use."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._items: Dict[str, Any] = {}

    def _get(self, name: str, cls, *args, **kwargs):
        with self._lock:
            inst = self._items.get(name)
            if inst is None:
                inst = cls(name, *args, **kwargs)
                self._items[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def ewma(self, name: str, smooth: float = 0.5) -> Ewma:
        return self._get(name, Ewma, smooth)

    def histogram(self, name: str, maxlen: int = 2048) -> Histogram:
        return self._get(name, Histogram, maxlen)

    def get(self, name: str):
        """Existing instrument or None — read-side lookups must not
        create empty instruments."""
        with self._lock:
            return self._items.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._items)

    # -- snapshot endpoint --------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            items = list(self._items.items())
        return {name: inst.snapshot() for name, inst in sorted(items)}

    def dump(self, path: str) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    def render(self) -> str:
        """Fixed-width text table (the ``--obs_report`` body)."""
        rows = [("metric", "type", "count", "value/mean", "p50", "p99")]

        def fmt(v) -> str:
            if v is None:
                return "-"
            if isinstance(v, float):
                return f"{v:.6g}"
            return str(v)

        for name, snap in self.snapshot().items():
            kind = snap["type"]
            if kind == "counter":
                rows.append((name, kind, fmt(snap["value"]), "-", "-", "-"))
            elif kind == "gauge":
                rows.append((name, kind, "-", fmt(snap["value"]), "-", "-"))
            elif kind == "ewma":
                rows.append((name, kind, fmt(snap["count"]),
                             fmt(snap["value"]), "-", "-"))
            else:
                rows.append((name, kind, fmt(snap["count"]), fmt(snap["mean"]),
                             fmt(snap["p50"]), fmt(snap["p99"])))
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        lines = []
        for i, row in enumerate(rows):
            lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
            if i == 0:
                lines.append("  ".join("-" * w for w in widths))
        return "\n".join(lines)
