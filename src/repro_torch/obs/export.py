"""Trace export — Chrome trace-event JSON and per-stage latency summaries.

``python -m repro_torch.obs.export --chrome out.json trace*.jsonl`` merges one
or more per-process trace files (see :mod:`repro_torch.obs.trace` for the
record schema) into a single Chrome trace-event JSON file that
``chrome://tracing`` and Perfetto (https://ui.perfetto.dev) render as a
fleet timeline: one track per (process, thread), spans as slices, events
as instants.  Because span timestamps are CLOCK_MONOTONIC and that clock
is system-wide on Linux, traces from different worker processes on one
host line up without skew correction.  A span's device interval
(``dev_t0`` / ``dev_s``, on the same clock through the anchor event its
site records after a synchronize; see :mod:`repro_torch.obs.trace`) is
drawn on a ``device`` track of its process: a chunk's as its ``trunk``
and ``fold``, any other under the span's name.  Spans are emitted off a
query's path, after its answers are released, so a timeline shows a
served batch once it is done.

``stage_summary`` / ``breakdown_table`` turn the same records into
per-stage latency tables; ``clock`` records are not stages and are
skipped.  Summaries report both
*inclusive* time (span duration) and *self* time (duration minus direct
children), so a parent ``scored`` span does not double-count its nested
``staged``/``encoded`` children in a breakdown.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Any, Dict, Iterable, List, Optional, Sequence

from repro_torch.obs.trace import LIFECYCLE_STAGES, read_trace

__all__ = ["load_traces", "to_chrome", "write_chrome", "stage_summary",
           "breakdown_table", "main"]

_STAGE_ORDER = {name: i for i, name in enumerate(LIFECYCLE_STAGES)}
#: the thread id of each process's device track
DEVICE_TID = 2 ** 31 - 1


def load_traces(paths: Sequence[str]) -> List[Dict[str, Any]]:
    """Read and merge trace files; each record gains a ``_file`` key so
    span ``id``/``parent`` references (file-local) stay resolvable."""
    records: List[Dict[str, Any]] = []
    for path in paths:
        for rec in read_trace(path):
            rec = dict(rec, _file=os.path.abspath(path))
            records.append(rec)
    return records


def _sort_key(rec: Dict[str, Any]):
    t = rec.get("t0", rec.get("t", 0.0)) or 0.0
    return (t, _STAGE_ORDER.get(rec.get("name"), len(_STAGE_ORDER)))


def to_chrome(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Convert merged trace records to a Chrome trace-event dict.

    Spans become complete events (``ph: "X"``, microsecond ``ts``/``dur``)
    and instants become ``ph: "i"`` with thread scope; process-name
    metadata events label each track with the tracer's ``process`` string.
    """
    meta_keys = ("kind", "name", "id", "parent", "t0", "t", "dur",
                 "pid", "tid", "process", "_file")
    events: List[Dict[str, Any]] = []
    named: Dict[int, str] = {}
    device_tracks: set = set()
    for rec in sorted(records, key=_sort_key):
        pid = int(rec.get("pid", 0))
        tid = int(rec.get("tid", 0)) % 2 ** 31  # chrome wants small-ish ints
        proc = rec.get("process")
        if proc and named.get(pid) != proc:
            named[pid] = proc
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": tid, "args": {"name": str(proc)}})
        args = {k: v for k, v in rec.items() if k not in meta_keys}
        if rec.get("id") is not None:
            args["span_id"] = rec["id"]
        if rec.get("parent") is not None:
            args["parent_id"] = rec["parent"]
        if rec.get("kind") == "span":
            events.append({
                "ph": "X", "name": str(rec.get("name")), "cat": "lifecycle",
                "ts": float(rec.get("t0", 0.0)) * 1e6,
                "dur": max(1.0, float(rec.get("dur", 0.0)) * 1e6),
                "pid": pid, "tid": tid, "args": args})
            if rec.get("dev_t0") is not None:
                if pid not in device_tracks:
                    device_tracks.add(pid)
                    events.append({"ph": "M", "name": "thread_name",
                                   "pid": pid, "tid": DEVICE_TID,
                                   "args": {"name": "device"}})
                events.extend(_device_slices(rec, pid, args))
        elif rec.get("kind") == "event":
            events.append({
                "ph": "i", "s": "t", "name": str(rec.get("name")),
                "cat": "lifecycle", "ts": float(rec.get("t", 0.0)) * 1e6,
                "pid": pid, "tid": tid, "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _device_slices(rec: Dict[str, Any], pid: int,
                   args: Dict[str, Any]) -> List[Dict[str, Any]]:
    """A span's device interval as slices of its process's device track:
    ``trunk`` and ``fold`` where the span splits it, else one slice."""
    t0 = float(rec["dev_t0"])
    if rec.get("trunk_s") is not None and rec.get("fold_s") is not None:
        parts = [("trunk", t0, float(rec["trunk_s"])),
                 ("fold", t0 + float(rec["trunk_s"]), float(rec["fold_s"]))]
    else:
        parts = [(str(rec.get("name")), t0, float(rec.get("dev_s", 0.0)))]
    return [{"ph": "X", "name": name, "cat": "device", "ts": ts * 1e6,
             "dur": max(1.0, dur * 1e6), "pid": pid, "tid": DEVICE_TID,
             "args": args} for name, ts, dur in parts]


def write_chrome(paths: Sequence[str], out: str) -> Dict[str, Any]:
    doc = to_chrome(load_traces(paths))
    tmp = f"{out}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    os.replace(tmp, out)
    return doc


def _percentile(vals: List[float], p: float) -> Optional[float]:
    if not vals:
        return None
    vals = sorted(vals)
    rank = max(1, int(math.ceil(p / 100.0 * len(vals))))
    return vals[min(rank, len(vals)) - 1]


def stage_summary(records: Iterable[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Per-stage latency summary over span records.

    Returns ``{name: {count, total_s, self_s, mean_s, p50_s, p99_s}}``
    where ``self_s`` excludes time spent in *direct child* spans (same
    file, ``parent`` pointing at the span) — the additive view for
    breakdown tables.  Events contribute ``count`` only.
    """
    recs = [r for r in records if r.get("kind") != "clock"]
    child_time: Dict[Any, float] = {}
    for rec in recs:
        if rec.get("kind") == "span" and rec.get("parent") is not None:
            key = (rec.get("_file"), rec.get("pid"), rec["parent"])
            child_time[key] = child_time.get(key, 0.0) \
                + float(rec.get("dur", 0.0))
    out: Dict[str, Dict[str, Any]] = {}
    for rec in recs:
        name = rec.get("name")
        ent = out.setdefault(name, {"count": 0, "total_s": 0.0,
                                    "self_s": 0.0, "durs": []})
        ent["count"] += 1
        if rec.get("kind") != "span":
            continue
        dur = float(rec.get("dur", 0.0))
        key = (rec.get("_file"), rec.get("pid"), rec.get("id"))
        ent["total_s"] += dur
        ent["self_s"] += max(0.0, dur - child_time.get(key, 0.0))
        ent["durs"].append(dur)
    for ent in out.values():
        durs = ent.pop("durs")
        ent["mean_s"] = (ent["total_s"] / len(durs)) if durs else None
        ent["p50_s"] = _percentile(durs, 50)
        ent["p99_s"] = _percentile(durs, 99)
    return out


def breakdown_table(records: Iterable[Dict[str, Any]]) -> str:
    """Fixed-width latency-breakdown table in lifecycle order."""
    summary = stage_summary(records)
    rows = [("stage", "count", "total_s", "self_s", "mean_s", "p50_s",
             "p99_s")]

    def fmt(v) -> str:
        return "-" if v is None else (f"{v:.4f}" if isinstance(v, float)
                                      else str(v))

    names = sorted(summary, key=lambda n: (_STAGE_ORDER.get(n, 99), str(n)))
    for name in names:
        ent = summary[name]
        rows.append((str(name), fmt(ent["count"]), fmt(ent["total_s"]),
                     fmt(ent["self_s"]), fmt(ent["mean_s"]),
                     fmt(ent["p50_s"]), fmt(ent["p99_s"])))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = []
    for i, row in enumerate(rows):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.export",
        description="Export lifecycle trace files to Chrome trace-event "
                    "JSON (open in chrome://tracing or Perfetto) and/or "
                    "print a per-stage latency summary.")
    ap.add_argument("traces", nargs="+", help="trace .jsonl files to merge")
    ap.add_argument("--chrome", default=None, metavar="OUT.json",
                    help="write merged Chrome trace-event JSON here")
    ap.add_argument("--summary", action="store_true",
                    help="print the per-stage latency breakdown table")
    args = ap.parse_args(argv)
    records = load_traces(args.traces)
    if args.chrome:
        doc = write_chrome(args.traces, args.chrome)
        print(f"wrote {args.chrome}: {len(doc['traceEvents'])} events "
              f"from {len(args.traces)} trace file(s)")
    if args.summary or not args.chrome:
        print(breakdown_table(records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
