"""The program's own spans of a traced run (``ctx["spans"]``, written by
``repro_torch.obs``), cut to what the window measured.

Validation: the ``scored`` spans in time order are set-up's warm-up
verdicts, the window's verdicts (as many as ``ctx["verdicts"]``) and the
traced verdict last.  A window verdict's ``restored`` span lies between
the end of the verdict before it and its own ``scored`` span; its engine
spans are the ``scored`` span's children.  Serving: the window's
requests are the last ``ctx["n_answered"]`` ``queued`` spans by submit
time (set-up's warm-up is answered before the window starts), and its
batches are the ``served`` spans dispatched after the first of them.

Each helper returns None where the spans it reads are missing (a program
without them), and never raises on that.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional


def _named(spans, name: str) -> List[dict]:
    return sorted((s for s in spans
                   if s.get("kind") == "span" and s.get("name") == name),
                  key=lambda s: s["t0"])


def window_verdicts(ctx) -> Optional[List[List[dict]]]:
    """The spans of each verdict of the window: its ``restored`` spans
    and the spans its ``scored`` span holds."""
    if ctx.get("kind") != "validate" or not ctx.get("spans"):
        return None
    n = len(ctx.get("verdicts") or ())
    spans = ctx["spans"]
    scored = [s for s in _named(spans, "scored") if "error" not in s]
    if not n or len(scored) < n + 2:
        return None
    window, before = scored[-n - 1:-1], scored[-n - 2:-2]
    restored = _named(spans, "restored")
    children: Dict[int, List[dict]] = {}
    for s in spans:
        if s.get("parent") is not None:
            children.setdefault(s["parent"], []).append(s)
    return [[r for r in restored if p["t0"] + p["dur"] <= r["t0"] <= v["t0"]]
            + children.get(v["id"], []) for v, p in zip(window, before)]


def verdict_mean(ctx, name: str, value: Callable[[List[dict]], float]
                 ) -> Optional[float]:
    """The mean over the window's verdicts of ``value(spans)``, where
    ``spans`` are a verdict's spans called ``name``; None where no
    verdict has one."""
    vs = window_verdicts(ctx)
    if vs is None:
        return None
    per = [[s for s in v if s.get("name") == name] for v in vs]
    if not any(per):
        return None
    return sum(value(s) for s in per) / len(per)


def union_s(intervals, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` that the ``(start, end)`` intervals
    cover."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def window_requests(ctx) -> Optional[List[dict]]:
    """The ``queued`` spans of the window's answered queries."""
    if ctx.get("kind") != "serve" or not ctx.get("spans"):
        return None
    n = ctx.get("n_answered") or 0
    queued = _named(ctx["spans"], "queued")
    if not n or len(queued) < n:
        return None
    return queued[-n:]


def window_topk(ctx) -> Optional[List[dict]]:
    """The ``topk`` spans of the window's batches."""
    reqs = window_requests(ctx)
    if reqs is None:
        return None
    start = reqs[0]["t0"]
    batches = {s["id"] for s in _named(ctx["spans"], "served")
               if s["t0"] >= start}
    topk = [s for s in _named(ctx["spans"], "topk")
            if s.get("parent") in batches]
    return topk or None


def nearest_rank(values, p: float) -> float:
    xs = sorted(values)
    return xs[max(0, math.ceil(p / 100.0 * len(xs)) - 1)]
