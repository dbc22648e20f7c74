"""Serving: an open-loop stream of queries into the port's ``QueryService``
over a resident ``ServingIndex``.

Set-up draws the query encoder's weights and the index's rows (seeded
unit rows standing in for a corpus encoded by the checkpoint) on the
device, installs the index, starts the service and warms it up.  The
window sends ``rate_qps * seconds`` queries on a seeded Poisson schedule
from a pool of client threads, whether or not earlier ones have been
answered; the pool holds a thread for every query the service can take
in (its admission bound and a batch), so an overload queues in the
service and is refused by its admission, not held back by the pool.
Each query is timed from the moment it was due to its answer, and one
that is refused or fails counts as infinitely late.

The check: a seeded sample of the answered queries, with the longest
among them, is encoded again by the reference in float32 and searched
exactly over the same rows, made again from the seed block by block, and
every answer in the sample is judged (:mod:`bench.judge`).
"""

from __future__ import annotations

import concurrent.futures as cf
import gc
import math
import os
import shutil
import tempfile
import time

import torch

from bench import gen, judge, port, roofline, weights
from bench import trace as tracing
from bench.reference import encoders, search


class RowIds:
    """Document ids ``"0" .. str(n - 1)`` of the index's rows, made on
    demand instead of held as millions of strings."""

    def __init__(self, n: int):
        self.n = int(n)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, j) -> str:
        j = int(j)
        if not 0 <= j < self.n:
            raise IndexError(j)
        return str(j)


def unit_rows(seed: int, block: int, n: int, dim: int, device
              ) -> torch.Tensor:
    """Block ``block`` of the index: ``n`` seeded rows of unit length."""
    g = torch.Generator(device=device)
    g.manual_seed(gen.torch_seed(seed, 20, block))
    x = torch.randn(n, dim, generator=g, device=device)
    return x.div_(x.norm(dim=1, keepdim=True))


def index_rows(seed: int, n: int, dim: int, block: int, device
               ) -> torch.Tensor:
    emb = torch.empty(n, dim, device=device)
    for b, lo in enumerate(range(0, n, block)):
        hi = min(n, lo + block)
        emb[lo:hi] = unit_rows(seed, b, hi - lo, dim, device)
    return emb


def p95(latencies_s) -> float:
    """Nearest-rank 95th percentile (a latency some query really had)."""
    xs = sorted(latencies_s)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def run(*, cfg, mix, seed, seconds, trace: bool, device, t_start, limits,
        rate=None) -> dict:
    from repro_torch.obs import Telemetry, read_trace
    from repro_torch.serve.admission import (AdmissionController,
                                             ServeOverloaded)
    from repro_torch.serve.index import ServingIndex
    from repro_torch.serve.service import QueryService

    dev = torch.device(device)
    rate = float(rate if rate is not None else mix["rate_qps"])
    N, D, k = mix["corpus_rows"], cfg["hidden_size"], mix["k"]
    r = cfg["retriever"]
    work = tempfile.mkdtemp(prefix="bench-serve-")
    pool = cf.ThreadPoolExecutor(
        max_workers=mix["max_pending"] + mix["max_batch"])
    svc = None
    try:
        spec = port.encoder_spec(cfg, dev)
        params = weights.nest(weights.draw(cfg, seed, 1, dev))
        emb = index_rows(seed, N, D, mix["row_block"], dev)
        index = ServingIndex(step=1, params=params, doc_ids=RowIds(N),
                             emb=emb, n_docs=N,
                             score_dtype=mix["score_dtype"],
                             impl=mix["impl"], block=mix["block"],
                             build_s=0.0)
        tel = Telemetry(os.path.join(work, "spans.jsonl")) if trace else None
        svc = QueryService(spec, k=k, max_batch=mix["max_batch"],
                           flush_ms=mix["flush_ms"],
                           admission=AdmissionController(
                               mix["max_pending"]),
                           telemetry=tel)
        svc.install(index)
        svc.start()
        stream = gen.query_stream(mix, seed, cfg["vocab_size"], seconds,
                                  rate)
        # warm-up: the service's one batch shape, from the pool's threads
        warm = gen.query_stream(mix, seed + 1, cfg["vocab_size"], 1.0,
                                4.0 * mix["max_batch"])
        list(pool.map(lambda i: svc.submit(f"w{i}", warm["tokens"][i]),
                      range(len(warm["tokens"]))))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        occ = tel.metrics.histogram("serve.batch_occupancy") if trace \
            else None
        occ0 = (occ.count, occ.total) if trace else (0, 0.0)

        due, toks = stream["due"], stream["tokens"]
        n = len(due)
        # set-up's objects out of the collector's way: a full collection
        # over them stalled every thread for ~0.1 s inside the window
        gc.collect()
        gc.freeze()

        def client(i):
            try:
                resp = svc.submit(stream["qids"][i], toks[i],
                                  timeout=seconds + 120.0)
                return "ok", time.perf_counter(), resp
            except ServeOverloaded:
                return "refused", time.perf_counter(), None
            except Exception as e:  # a failed query is a result
                return "error", time.perf_counter(), repr(e)[:300]

        # traced: the profiler records the whole window (started before
        # it, stopped after the last query is sent, so the sender never
        # waits on it) and the reduction reads a steady stretch in its
        # middle: three seconds, or the middle half of a shorter window
        win = tracing.Window(dev) if trace else None
        futures, late = [], 0.0
        if win is not None:
            win.start()
        t0 = time.perf_counter() + 0.05
        t0_ns = time.time_ns() + 50_000_000
        setup_s = t0 - t_start
        for i in range(n):
            target = t0 + due[i]
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
            late = max(late, time.perf_counter() - target)
            futures.append(pool.submit(client, i))
        if win is not None:
            win.stop()
        results = []
        for f in futures:
            try:
                results.append(f.result(
                    timeout=max(0.0, t0 + seconds + 60.0
                                - time.perf_counter())))
            except cf.TimeoutError:
                results.append(("never", math.inf, None))
        memory_peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        lat = [(res[1] - (t0 + due[i])) if res[0] == "ok" else math.inf
               for i, res in enumerate(results)]
        answered = [i for i, res in enumerate(results) if res[0] == "ok"]
        refused = sum(res[0] == "refused" for res in results)
        broken = sum(res[0] in ("error", "never") for res in results)
        p95_s = p95(lat)
        t_last = max((results[i][1] for i in answered), default=t0)

        tr = tracing.NONE
        if win is not None:
            half = min(1.5, seconds / 4)
            tr = win.reduce(t0_ns + int(1e9 * (seconds / 2 - half)),
                            t0_ns + int(1e9 * (seconds / 2 + half)))
        ctx = {"kind": "serve", "trace": tr, "rate_qps": rate,
               "window_s": t_last - t0, "n_answered": len(answered)}
        if trace:
            ctx["occupancy"] = (occ.total - occ0[1]) / max(
                1, occ.count - occ0[0])
            tel.flush()
            ctx["spans"] = read_trace(os.path.join(work, "spans.jsonl"))
        ctx["flops"] = sum(
            roofline.encoder_flops(cfg, min(len(toks[i]), r["q_max_len"]))
            + roofline.score_flops(1, N, D) for i in answered)
        gc.unfreeze()
        svc.stop()
        if trace:
            ctx.update(time_topk(index, spec, params, toks, mix, dev))

        sample = checked_sample(seed, answered, toks, mix["check_sample"])
        served = {i: results[i][2] for i in sample}
        svc = index = emb = params = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        readings = judge_answers(cfg, mix, seed, dev,
                                 [toks[i] for i in sample],
                                 [served[i].doc_ids for i in sample],
                                 [served[i].scores for i in sample])
        ref_s = time.perf_counter() - t_ref
        correct, checks = judge.decide(readings, limits)
        correct = correct and broken == 0 and bool(answered)
        log = {"setup_s": setup_s, "queries": n, "answered": len(answered),
               "refused": refused, "broken": broken,
               "p50_ms": 1e3 * sorted(lat)[n // 2], "p95_ms": 1e3 * p95_s,
               "max_ms": 1e3 * max(lat), "late_ms": 1e3 * late,
               "sample": len(sample), "reference_s": ref_s}
        return {"measured": {"setup_s": setup_s,
                             "query_p95_ms": 1e3 * p95_s
                             if math.isfinite(p95_s) else 1e30},
                "ctx": ctx, "readings": readings, "checks": checks,
                "correct": correct and math.isfinite(p95_s),
                "attempted": n, "failed": refused + broken,
                "memory_peak": memory_peak, "log": log,
                "latencies_s": lat}
    finally:
        gc.unfreeze()
        if svc is not None:
            svc.stop()
        pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(work, ignore_errors=True)


def checked_sample(seed, candidates, toks, size):
    """The queries a run judges, drawn from the seed out of
    ``candidates``: the longest, and ``size - 1`` others."""
    if not candidates:
        return []
    longest = max(candidates, key=lambda i: len(toks[i]))
    rest = [i for i in candidates if i != longest]
    pick = gen.rng(seed, 3).choice(len(rest), min(len(rest), size - 1),
                                   replace=False) if rest else []
    return [longest] + [rest[int(j)] for j in pick]


def time_topk(index, spec, params, toks, mix, dev, calls: int = 10) -> dict:
    """``ServingIndex.topk`` on the live index at one micro-batch's shape,
    timed with CUDA events, and its bound."""
    from repro_torch.data.corpus import pad_batch
    B, k = mix["max_batch"], mix["k"]
    t, m = pad_batch(list(toks[:B]), spec.q_max_len)
    with torch.inference_mode():
        q = spec.encode_query(params, torch.from_numpy(t).to(dev),
                              torch.from_numpy(m).to(dev))
        for _ in range(2):
            index.topk(q, k=k)
        if dev.type != "cuda":
            return {}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            index.topk(q, k=k)
        end.record()
        torch.cuda.synchronize(dev)
    bound = roofline.search_bound_s(B, index.n_docs, q.shape[1], k)
    return {"topk_s": start.elapsed_time(end) / 1e3 / calls,
            "topk_bound_s": bound["s"], "topk_bound_by": bound["by"]}


def reference_queries(cfg, seed, dev, texts, precision="f32"):
    encoders.exact_matmul()
    W = weights.draw(cfg, seed, 1, dev)
    qe = encoders.encode(cfg, W, texts, cfg["retriever"]["q_max_len"],
                         precision=precision)
    del W
    return qe


def scan(mix, seed, dev, qe, dim, returned=None):
    """One pass over the index's rows, made again from the seed block by
    block: the exact top ``k`` of ``qe``'s scores and, for ``returned``
    row ids (Q, k), the scores of those rows."""
    N, k, blk = mix["corpus_rows"], mix["k"], mix["row_block"]
    Q = qe.shape[0]
    vals = torch.full((Q, 0), -math.inf, device=dev)
    idx = torch.zeros((Q, 0), dtype=torch.long, device=dev)
    got = torch.full((Q, k), math.nan, device=dev)
    for b, lo in enumerate(range(0, N, blk)):
        hi = min(N, lo + blk)
        s = qe @ unit_rows(seed, b, hi - lo, dim, dev).T
        tv, ti = search.exact_topk(s, min(k, hi - lo))
        vals, idx = search.merge_topk(vals, idx, tv, ti + lo, k)
        if returned is not None:
            inside = (returned >= lo) & (returned < hi)
            qi = torch.arange(Q, device=dev)[:, None].expand(-1, k)
            got[inside] = s[qi[inside], returned[inside] - lo]
    return vals, idx, got


def judge_answers(cfg, mix, seed, dev, texts, ids, scores) -> dict:
    k, N = mix["k"], mix["corpus_rows"]
    if not texts:
        return {}
    qe = reference_queries(cfg, seed, dev, texts)
    rows, good, malformed = [], [], 0
    for doc_ids, sc in zip(ids, scores):
        try:
            r = [int(d) for d in doc_ids]
        except ValueError:
            r = []
        if len(r) != k or len(set(r)) != k or len(sc) != k \
                or not all(0 <= j < N for j in r):
            malformed += 1
            r, sc = list(range(k)), [math.inf] * k
        rows.append(r)
        good.append(sc)
    returned = torch.tensor(rows, device=dev)
    top, _, got = scan(mix, seed, dev, qe, cfg["hidden_size"], returned)
    out = judge.list_gaps(got.cpu(), torch.tensor(good, dtype=torch.float64),
                          top.cpu())
    out["malformed"] = float(malformed)
    return out


def control(*, cfg, mix, seed, device, seconds) -> dict:
    """The readings of the control: the reference in the program's place,
    its query trunk's weight products in fp8, on a sample drawn as a
    run's is (with the longest query), judged as a run's answers are."""
    dev = torch.device(device)
    stream = gen.query_stream(mix, seed, cfg["vocab_size"], seconds,
                              mix["rate_qps"])
    toks = stream["tokens"]
    texts = [toks[i] for i in checked_sample(seed, range(len(toks)), toks,
                                             mix["check_sample"])]
    q8 = reference_queries(cfg, seed, dev, texts, precision="fp8")
    vals, idx, _ = scan(mix, seed, dev, q8, cfg["hidden_size"])
    return judge_answers(cfg, mix, seed, dev, texts,
                         [[str(j) for j in row] for row in idx.tolist()],
                         vals.tolist())
