"""Validation: checkpoints restored and validated back to back by an idle
validator, through ``ValidatorWorker.run_step``.

Set-up makes the validation set from the seed, builds the port's
``ValidationSuite`` (the mix's sampler, engine, impl and metrics), commits
``checkpoints`` checkpoints of distinct seeded weights under ``TMPDIR``,
and warms up with one verdict of each.  The window validates the
checkpoints in turn, so every verdict restores from disk, until
``seconds`` have passed and every checkpoint has been validated;
``verdict_s`` is the span from the first restore to the last ledger row,
over the verdicts completed.  The engine is wrapped only to keep each
verdict's run and scores for the check.

The check: the reference encodes the queries and the subset again with
the weights of every checkpoint, in float32, and judges every verdict in
the window (:mod:`bench.judge`), and the ledger's metrics against the
reference's metrics of the same run.  Judging every checkpoint is what
catches a validator that keeps a tree it restored earlier.
"""

from __future__ import annotations

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


class _Capture:
    """The suite's engine, keeping what each ``run`` returned."""

    def __init__(self, engine):
        self.engine = engine
        self.outputs = []

    def run(self, params):
        out = self.engine.run(params)
        self.outputs.append(out[:2])
        return out

    def __getattr__(self, name):
        return getattr(self.engine, name)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def suite_for(cfg, mix, data, dev, telemetry=None):
    from repro_torch.core.suite import (ValidationConfig, ValidationSuite,
                                        ValidationTask)
    task = ValidationTask(name="default", corpus=data["corpus"],
                          queries=data["queries"], qrels=data["qrels"],
                          sampler=mix["sampler"], sampler_depth=mix["depth"],
                          baseline_run=data["run"])
    vcfg = ValidationConfig(
        metrics=tuple(mix["metrics"]), k=mix["k"],
        batch_size=mix["batch_size"], chunk_size=mix["chunk_size"],
        impl=mix["impl"], engine=mix["engine"],
        score_dtype=mix["score_dtype"], telemetry=telemetry)
    return ValidationSuite(port.encoder_spec(cfg, dev), [task], vcfg)


def reference_scores(cfg, mix, data, seed, steps, dev, precision="f32"):
    """{step: (Q, N) scores on the host} of the reference encoders over the
    queries and the paper's subset, and the subset's ids."""
    encoders.exact_matmul()
    r = cfg["retriever"]
    sub = search.subset_ids(list(data["corpus"]), data["run"],
                            data["qrels"], mix["depth"])
    qtexts = list(data["queries"].values())
    ptexts = [data["corpus"][d] for d in sub]
    out = {}
    for step in steps:
        W = weights.draw(cfg, seed, step, dev)
        qe = encoders.encode(cfg, W, qtexts, r["q_max_len"],
                             precision=precision)
        pe = encoders.encode(cfg, W, ptexts, r["p_max_len"],
                             precision=precision)
        out[step] = (qe @ pe.T).cpu()
        del W, qe, pe
    return out, sub


def judge_verdicts(verdicts, ref, sub, data, mix):
    """The readings of every verdict against the reference's scores."""
    qids = list(data["queries"])
    pos_of = {d: i for i, d in enumerate(sub)}
    k = min(mix["k"], len(sub))
    readings, malformed = [], 0
    for v in verdicts:
        run, scores = v["output"]
        S = ref[v["step"]]
        top = search.exact_topk(S, k)[0]
        cols, got = [], []
        for qid in qids:
            p = judge.positions(run.get(qid, []), pos_of, k)
            if p is None or len(scores.get(qid, [])) != k:
                malformed += 1
                p, s = [0] * k, [math.inf] * k
            else:
                s = scores[qid]
            cols.append(p)
            got.append(s)
        cols = torch.tensor(cols)
        R = torch.gather(S, 1, cols)
        rd = judge.list_gaps(R, torch.tensor(got, dtype=torch.float64), top)
        row = v.get("row")
        if row is None or row.get("step") != v["step"] \
                or len(run) != len(qids):
            malformed += 1
            rd["metric_err"] = math.inf
        else:
            rd["metric_err"] = max(
                abs(row["metrics"][m] - search.metric(m, run, data["qrels"]))
                for m in mix["metrics"])
        readings.append(rd)
    out = judge.worst(readings)
    out["malformed"] = float(malformed)
    return out


def run(*, cfg, mix, seed, seconds, trace: bool, device, t_start, limits
        ) -> dict:
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.core.validator import ValidationLedger, ValidatorWorker
    from repro_torch.obs import Telemetry, read_trace

    dev = torch.device(device)
    data = gen.validation_set(mix, seed, cfg["vocab_size"])
    work = tempfile.mkdtemp(prefix="bench-validate-")
    try:
        tel = Telemetry(os.path.join(work, "spans.jsonl")) if trace else None
        suite = suite_for(cfg, mix, data, dev, telemetry=tel)
        cap = _Capture(suite.engine("default"))
        ckpts = os.path.join(work, "ckpts")
        steps = list(range(1, mix["checkpoints"] + 1))
        for step in steps:
            w = weights.draw(cfg, seed, step, dev)
            ckpt.save(ckpts, step, {"params": weights.nest(w)})
            del w
        ledger_path = os.path.join(work, "ledger.jsonl")
        worker = ValidatorWorker(
            ckpts, suite, engine=cap, telemetry=tel,
            ledger=ValidationLedger(ledger_path, expected_tasks=("default",),
                                    telemetry=tel))
        for step in steps:                  # warm-up: one verdict each, so
            worker.run_step(step)           # the allocator holds two trees
        n_warm = len(cap.outputs)
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

        verdicts, failed, errors = [], 0, []
        # set-up's objects out of the collector's way inside the window
        gc.collect()
        gc.freeze()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        i = 0
        while True:
            step = steps[i % len(steps)]
            i += 1
            ta = time.perf_counter()
            try:
                res = worker.run_step(step)
            except Exception as e:          # a failed verdict is a result
                failed += 1
                errors.append(repr(e)[:300])
                res = None
            tb = time.perf_counter()
            if res is not None:
                verdicts.append({"step": step, "wall_s": tb - ta,
                                 "timings": dict(res.timings),
                                 "output": cap.outputs[-1]})
            # every checkpoint once at least, so each is judged
            if tb - t0 >= seconds and i >= len(steps):
                break
        t_end = time.perf_counter()
        gc.unfreeze()
        memory_peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        n_ok = len(verdicts)
        verdict_s = (t_end - t0) / n_ok if n_ok else math.inf

        tr = tracing.NONE
        if trace:
            step = steps[i % len(steps)]
            ta = time.perf_counter()
            res, tr = tracing.traced(lambda: worker.run_step(step), dev)
            verdicts.append({"step": step, "wall_s": time.perf_counter() - ta,
                             "timings": dict(res.timings),
                             "output": cap.outputs[-1], "traced": True})
            tel.flush()
        rows = _ledger_rows(ledger_path)[n_warm:]
        for v, row in zip(verdicts, rows):
            v["row"] = row
        spans = read_trace(os.path.join(work, "spans.jsonl")) \
            if trace else []
        registry = tel.metrics.snapshot() if trace else {}
        del worker, suite, cap, tel
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        ref, sub = reference_scores(cfg, mix, data, seed, steps, dev)
        readings = judge_verdicts(verdicts, ref, sub, data, mix) \
            if verdicts else {}
        ref_s = time.perf_counter() - t_ref
        correct, checks = judge.decide(readings, limits)
        correct = correct and failed == 0 and n_ok > 0

        r = cfg["retriever"]
        flops = roofline.encode_flops(
            cfg, [min(len(data["corpus"][d]), r["p_max_len"]) for d in sub])
        flops += roofline.encode_flops(
            cfg, [min(len(t), r["q_max_len"])
                  for t in data["queries"].values()])
        flops += roofline.score_flops(len(data["queries"]), len(sub),
                                      cfg["hidden_size"])
        window = [{k: v[k] for k in ("step", "wall_s", "timings")}
                  for v in verdicts if not v.get("traced")]
        ctx = {"kind": "validate", "verdicts": window,
               "verdict_s": verdict_s, "flops_per_verdict": flops,
               "trace": tr, "spans": spans, "registry": registry}
        log = {"setup_s": setup_s, "verdicts": n_ok, "judged": len(verdicts),
               "walls_s": [v["wall_s"] for v in window],
               "subset": len(sub), "reference_s": ref_s, "errors": errors}
        return {"measured": {"setup_s": setup_s, "verdict_s": verdict_s},
                "ctx": ctx, "readings": readings, "checks": checks,
                "correct": correct, "attempted": n_ok + failed,
                "failed": failed, "memory_peak": memory_peak, "log": log}
    finally:
        gc.unfreeze()
        shutil.rmtree(work, ignore_errors=True)


def _ledger_rows(path):
    import json
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def control(*, cfg, mix, seed, device, seconds) -> dict:
    """The readings of the control: the reference in the program's place,
    its weight products in fp8, judged as a run's verdicts are."""
    dev = torch.device(device)
    data = gen.validation_set(mix, seed, cfg["vocab_size"])
    steps = list(range(1, mix["checkpoints"] + 1))
    ref, sub = reference_scores(cfg, mix, data, seed, steps, dev)
    low, _ = reference_scores(cfg, mix, data, seed, steps, dev,
                              precision="fp8")
    k = min(mix["k"], len(sub))
    qids = list(data["queries"])
    verdicts = []
    for step in steps:
        vals, idx = search.exact_topk(low[step], k)
        run = {q: [sub[j] for j in idx[qi].tolist()]
               for qi, q in enumerate(qids)}
        scores = {q: vals[qi].tolist() for qi, q in enumerate(qids)}
        row = {"step": step, "metrics": {
            m: search.metric(m, run, data["qrels"]) for m in mix["metrics"]}}
        verdicts.append({"step": step, "output": (run, scores), "row": row})
    return judge_verdicts(verdicts, ref, sub, data, mix)
