"""The device trace of a traced run, reduced to what the metrics read.

:func:`traced` runs a callable under ``torch.profiler`` and reads the
profiler's events in memory, without writing a trace file: the union of
the device's kernel, copy and set intervals in the window (``busy_s``),
the device time by kernel name, and the idle gaps, each named after the
innermost host event that was running at its middle.  Only the device's
activity and the CUDA calls the host made are recorded (no operator
events): recording every PyTorch operator slowed the host by half in a
verdict and so inflated the idle share it measures.  A gap during which
the host made no CUDA call is the host's own Python work.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Tuple

Span = Tuple[int, int, str]          # (start ns, end ns, name)

#: idle gaps shorter than this are launch latency, not named
MIN_GAP_NS = 10_000
TOP = 10
#: host events searched back from a gap for the one running at its middle
LOOKBACK = 64
NO_CALL = "host: Python, no CUDA call"
#: the reduction of an untraced run
NONE = {"busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": []}


def _events(prof) -> Tuple[List[Span], List[Span]]:
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.device_type() == DeviceType.CUDA:
            dev.append(span)
        elif e.device_type() == DeviceType.CPU:
            host.append(span)
    return dev, host


def _union(spans: List[Span], lo: int, hi: int) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e, _ in sorted(spans):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def _host_label(host: List[Span], starts: List[int], t: int) -> str:
    """The shortest of the last ``LOOKBACK`` host events begun before
    ``t`` that is still running at ``t``."""
    best, i = None, bisect.bisect_right(starts, t) - 1
    stop = max(-1, i - LOOKBACK)
    while i > stop:
        s, e, name = host[i]
        if e > t and (best is None or e - s < best[1] - best[0]):
            best = host[i]
        i -= 1
    return best[2] if best is not None else NO_CALL


def reduce(dev: List[Span], host: List[Span], lo: int, hi: int) -> dict:
    busy = _union(dev, lo, hi)
    busy_ns = sum(e - s for s, e in busy)
    by_op: Dict[str, int] = {}
    for s, e, name in dev:
        if min(e, hi) > max(s, lo):
            key = name[:80]
            by_op[key] = by_op.get(key, 0) + min(e, hi) - max(s, lo)
    host = sorted(host)
    starts = [s for s, _, _ in host]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    by_gap: Dict[str, int] = {}
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 - g0 >= MIN_GAP_NS:
            label = _host_label(host, starts, (g0 + g1) // 2)[:80]
            by_gap[label] = by_gap.get(label, 0) + (g1 - g0)

    def top(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])][:TOP]

    return {"busy_s": busy_ns / 1e9, "window_s": (hi - lo) / 1e9,
            "n_device_events": len(dev), "device_ops": top(by_op),
            "idle_gaps": top(by_gap),
            "device_ns_by_op": dict(by_op)}


def _activities(device):
    import torch
    from torch.profiler import ProfilerActivity
    # on the CPU (the benchmark's tests) there is no device to record
    return [ProfilerActivity.CUDA] if torch.device(device).type == "cuda" \
        else [ProfilerActivity.CPU]


def traced(fn: Callable, device) -> Tuple[object, dict]:
    """``(fn(), reduction)``: the window is the call, ended by a
    synchronise of ``device``."""
    import torch
    from torch.profiler import profile
    with profile(activities=_activities(device)) as prof:
        lo = time.time_ns()
        out = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        hi = time.time_ns()
    dev, host = _events(prof)
    return out, reduce(dev, host, lo, hi)


class Window:
    """A profiler window over a stretch of a run that other threads drive:
    :meth:`start` before the stretch, :meth:`stop` after it (both cheap
    once warm), :meth:`reduce` later, over any part of it."""

    def __init__(self, device):
        from torch.profiler import profile
        acts = _activities(device)
        # the first start in a process takes seconds: pay it here, before
        # the window, and not when the caller opens it
        warm = profile(activities=acts)
        warm.start()
        warm.stop()
        self.prof = profile(activities=acts)

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()

    def reduce(self, lo: int, hi: int) -> dict:
        """The reduction of ``[lo, hi)`` (``time.time_ns()`` values)."""
        dev, host = _events(self.prof)
        return reduce(dev, host, lo, hi)
