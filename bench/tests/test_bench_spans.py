"""The readers of the program's own spans (``bench/spans.py`` and the
metrics that use it) on synthetic span lists, a traced small serving run
on the CPU, and, on the card (``-m chip``), the serving cell's batch
device intervals on the profiler's clock."""

import math
from unittest import mock

import pytest

from bench import harness, spans

VALIDATE = ["restore_read_s.validate", "upload_s.validate",
            "trunk_s.validate", "fold_s.validate", "engine_idle_s.validate"]
SERVE = ["queue_wait_p95_ms.serve", "topk_issue_ms.serve",
         "topk_device_ms.serve"]


def _span(i, name, t0, dur, parent=None, **attrs):
    return dict(kind="span", name=name, id=i, parent=parent, t0=t0, dur=dur,
                **attrs)


def validate_ctx():
    """One warm-up verdict, two in the window, the traced one: each a
    restore, then a ``scored`` span holding an upload, the corpus loop and
    two chunks."""
    recs, i = [], 0
    for v in range(4):
        base = 10.0 * v
        i += 1
        recs.append(_span(i, "restored", base, 0.5 + v))
        sid = i = i + 1
        recs.append(_span(sid, "scored", base + 1.0, 5.0))
        recs.append(_span(i + 1, "uploaded", base + 1.0, 0.25 * (v + 1),
                          parent=sid))
        recs.append(_span(i + 2, "encoded", base + 2.0, 4.0, parent=sid,
                          role="corpus"))
        # chunks at [2.5, 3.5] and [4.0, 5.5] of the loop [2, 6]: 1.5 s idle
        recs.append(_span(i + 3, "chunk", base + 2.5, 1.0, parent=sid,
                          chunk=0, dev_t0=base + 2.5, dev_s=1.0,
                          trunk_s=0.75 + v, fold_s=0.25))
        recs.append(_span(i + 4, "chunk", base + 4.0, 1.5, parent=sid,
                          chunk=1, dev_t0=base + 4.0, dev_s=1.5,
                          trunk_s=1.0 + v, fold_s=0.5))
        i += 4
    return {"kind": "validate", "verdicts": [{}, {}], "spans": recs}


def serve_ctx():
    """Two warm-up queries, then three answered in the window, over two
    batches."""
    recs = [_span(1, "queued", 0.0, 9.0, batch=2),
            _span(2, "served", 0.5, 0.1),
            _span(3, "topk", 0.52, 0.05, parent=2, issue_s=0.9,
                  dev_t0=0.52, dev_s=0.9)]
    for j, (b, reqs) in enumerate([(10, [(1.0, 0.002), (1.001, 0.001)]),
                                   (20, [(2.0, 0.004)])]):
        t = 1.5 + j
        recs.append(_span(b, "served", t, 0.06))
        recs.append(_span(b + 1, "encoded", t, 0.01, parent=b,
                          role="query", dev_t0=t, dev_s=0.01))
        recs.append(_span(b + 2, "topk", t + 0.01, 0.05, parent=b,
                          issue_s=0.02 * (j + 1), dev_t0=t + 0.01,
                          dev_s=0.04 * (j + 1)))
        for k, (t0, dur) in enumerate(reqs):
            recs.append(_span(b + 3 + k, "queued", t0, dur, batch=b))
    return {"kind": "serve", "n_answered": 3, "spans": recs}


def test_validate_readers_on_synthetic_spans():
    ctx = validate_ctx()
    read = {n: harness.reader(n) for n in VALIDATE}
    # the window is the verdicts at 10 and 20 s
    assert math.isclose(read["restore_read_s.validate"](ctx), 2.0)
    assert math.isclose(read["upload_s.validate"](ctx), 0.625)
    assert math.isclose(read["trunk_s.validate"](ctx), 1.75 + 3.0)
    assert math.isclose(read["fold_s.validate"](ctx), 0.75)
    assert math.isclose(read["engine_idle_s.validate"](ctx), 1.5)
    for name in VALIDATE:
        assert read[name](serve_ctx()) is None
        assert read[name]({}) is None


def test_serve_readers_on_synthetic_spans():
    ctx = serve_ctx()
    read = {n: harness.reader(n) for n in SERVE}
    assert math.isclose(read["queue_wait_p95_ms.serve"](ctx), 4.0)
    assert math.isclose(read["topk_issue_ms.serve"](ctx), 30.0)
    assert math.isclose(read["topk_device_ms.serve"](ctx), 60.0)
    for name in SERVE:
        assert read[name](validate_ctx()) is None
        assert read[name]({}) is None


@pytest.mark.parametrize("drop", ["restored", "uploaded", "chunk",
                                  "queued", "topk"])
def test_readers_are_silent_without_the_spans(drop):
    """A program without the spans (the parent of this benchmark's
    readers) reads as nothing, never as zero."""
    v, s = validate_ctx(), serve_ctx()
    for ctx in (v, s):
        ctx["spans"] = [r for r in ctx["spans"] if r["name"] != drop]
    wanted = {"restored": ["restore_read_s.validate"],
              "uploaded": ["upload_s.validate"],
              "chunk": ["trunk_s.validate", "fold_s.validate",
                        "engine_idle_s.validate"],
              "queued": SERVE, "topk": SERVE[1:]}[drop]
    for name in wanted:
        ctx = v if name.endswith(".validate") else s
        assert harness.reader(name)(ctx) is None


def test_union_counts_overlaps_once():
    assert spans.union_s([(0.0, 2.0), (1.0, 3.0), (5.0, 9.0)], 0.5, 6.0) \
        == pytest.approx(3.5)
    assert spans.union_s([], 0.0, 1.0) == 0.0


def test_traced_small_serve_run_fails_no_query():
    from bench.tests.small import run_small
    res = run_small("dr-bert-base.serve-msmarco", seed=2 ** 31 + 11,
                    trace=True)
    assert res["correct"] and res["failed"] == 0
    assert res["log"]["refused"] == 0 and res["log"]["broken"] == 0
    assert all(res["metrics"][n]["value"] > 0 for n in SERVE)


def batch_intervals_ns(recs, clocks, names=("encoded", "topk")):
    """Each served batch's device interval, from its query trunk's start
    to its search's end (or that of its ``names`` children alone), in
    ``time.time_ns()`` nanoseconds."""
    from repro_torch.obs import to_time_ns
    kids = {}
    for r in recs:
        if r.get("name") in names and "dev_t0" in r:
            kids.setdefault(r["parent"], []).append(r)
    out = []
    for rs in kids.values():
        lo = min(r["dev_t0"] for r in rs)
        hi = max(r["dev_t0"] + r["dev_s"] for r in rs)
        out.append((to_time_ns(lo, clocks), to_time_ns(hi, clocks)))
    return out


def clock_check(seed: int, device, seconds: float = 51.0, **cell) -> dict:
    """A traced run of the serving cell (at its size, or ``cfg`` / ``mix``
    of ``cell``), and, over the profiler's stretch, the union of the
    program's batch device intervals put on the profiler's clock through
    the ``clock`` records, the profiler's ``busy_s``, and the part of it
    inside those intervals."""
    import time

    from bench import trace as tracing
    from repro_torch import obs
    seen = {}
    read_trace, reduce = obs.read_trace, tracing.Window.reduce

    def keep_trace(path, **kw):
        seen["clocks"] = read_trace(path, clocks=True)
        return read_trace(path, **kw)

    def keep_window(self, lo, hi):
        seen.update(win=self, lo=lo, hi=hi)
        return reduce(self, lo, hi)

    with mock.patch.object(obs, "read_trace", keep_trace), \
            mock.patch.object(tracing.Window, "reduce", keep_window):
        res = harness.run_cell(harness.load_benchmark(),
                               "dr-bert-base.serve-msmarco", seed=seed,
                               seconds=seconds, trace=True, device=device,
                               t_start=time.perf_counter(), **cell)
    lo, hi = seen["lo"], seen["hi"]
    recs = [r for r in seen["clocks"] if r.get("kind") != "clock"]
    busy = tracing._union(tracing._events(seen["win"].prof)[0], lo, hi)

    def covered(names):
        prog = batch_intervals_ns(recs, seen["clocks"], names)
        inside = spans.union_s(
            [(max(a, c), min(b, d)) for a, b in busy for c, d in prog
             if min(b, d) > max(a, c)], lo, hi)
        return spans.union_s(prog, lo, hi) / 1e9, inside / 1e9

    program_s, inside_s = covered(("encoded", "topk"))
    topk_s, topk_inside_s = covered(("topk",))
    return {"correct": res["correct"], "failed": res["failed"],
            "log": res["log"], "metrics": res["metrics"],
            "program_s": program_s, "busy_s": sum(b - a for a, b in busy)
            / 1e9, "busy_inside_s": inside_s, "topk_s": topk_s,
            "busy_inside_topk_s": topk_inside_s,
            "window_s": (hi - lo) / 1e9}


@pytest.mark.chip
def test_batch_device_intervals_share_the_profilers_clock(chip):
    """Put on the profiler's clock, the batches' device intervals hold
    the device's busy time, and their searches (device-bound, unlike the
    query trunk, whose interval is mostly its launches) cover as much
    time as the device was busy."""
    out = clock_check(2100000123, chip)
    assert out["correct"] and out["failed"] == 0
    assert out["busy_inside_s"] >= 0.95 * out["busy_s"]
    assert abs(out["topk_s"] - out["busy_s"]) <= 0.05 * out["busy_s"]
