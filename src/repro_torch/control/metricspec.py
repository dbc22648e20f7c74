"""Composite control-metric specs: ``"metric"``, ``"task:metric"``, or a
weighted aggregate — how the control plane consumes a multi-task suite
(``repro/control/metricspec.py``, pure Python, copied).

The validator's flat metric dict (see
:class:`repro_torch.core.suite.SuiteResult`) keys every value twice: bare
(``"MRR@10"``, the ``default`` task only — v1 ledger compatibility) and
task-qualified (``"dev:MRR@10"``).  A spec addresses either, or combines
several::

    "MRR@10"                              # single metric (v1 behaviour)
    "dev:MRR@10"                          # one task of a suite
    "0.5*dev:MRR@10 + 0.5*heldout:MRR@10" # weighted aggregate (Cho et al.
                                          # 2022: select checkpoints that
                                          # transfer across validation sets)

Grammar: ``spec := term ("+" term)*``, ``term := [weight "*"] key``.
Weights are floats (negative allowed, so a ``min`` series can contribute to
a ``max`` aggregate).  Parsing is eager and errors list what went wrong;
evaluation errors list the metric keys actually available, so a typo'd
task or metric fails loudly at the first observation, not as a silent
no-op."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    raw: str
    terms: Tuple[Tuple[float, str], ...]      # ((weight, key), ...)

    @classmethod
    def parse(cls, spec: str) -> "MetricSpec":
        if not isinstance(spec, str) or not spec.strip():
            raise ValueError(f"metric spec must be a non-empty string, "
                             f"got {spec!r}")
        terms: List[Tuple[float, str]] = []
        for part in spec.split("+"):
            part = part.strip()
            if not part:
                raise ValueError(f"empty term in metric spec {spec!r}")
            if "*" in part:
                w_s, key = part.split("*", 1)
                try:
                    w = float(w_s.strip())
                except ValueError:
                    raise ValueError(f"bad weight {w_s.strip()!r} in metric "
                                     f"spec {spec!r}") from None
            else:
                w, key = 1.0, part
            key = key.strip()
            if not key:
                raise ValueError(f"empty metric key in spec {spec!r}")
            terms.append((w, key))
        return cls(raw=spec, terms=tuple(terms))

    @property
    def composite(self) -> bool:
        return len(self.terms) > 1 or self.terms[0][0] != 1.0

    def keys(self) -> List[str]:
        return [k for _, k in self.terms]

    def _lookup(self, key: str, metrics: Dict[str, float]) -> float:
        try:
            return float(metrics[key])
        except KeyError:
            raise KeyError(
                f"metric {key!r} (from control spec {self.raw!r}) is not in "
                f"this run's metrics {sorted(metrics)}") from None

    def value(self, metrics: Dict[str, float]) -> float:
        """Evaluate against a flat metric dict.  An exact-key hit on the
        whole spec wins first — that is how the control plane overrides a
        composite series with its EMA-smoothed value."""
        if self.raw in metrics:
            return float(metrics[self.raw])
        return sum(w * self._lookup(k, metrics) for w, k in self.terms)


def flatten_rows(rows, expected_tasks=None, with_context=False,
                 group="consecutive"):
    """Group per-(step, task) ledger rows back into per-step flat metric
    dicts — the observation stream the control plane consumed online.

    ``group="consecutive"`` (single-validator ledgers): a suite records
    every task's row for a step consecutively, so CONSECUTIVE rows with the
    same step form one observation (two visits to the same step at
    different times stay two observations, preserving decision order).
    Schema-v1 rows (no ``"task"``) are the ``default`` task, whose metrics
    keep their bare names — a v1 ledger replays byte-identically to its
    pre-suite decisions.

    ``group="completion"`` (fleet ledgers): N workers interleave rows of
    DIFFERENT steps, so consecutive grouping would shred observations.
    Rows accumulate per step instead, and the observation is emitted at the
    position of the row that COMPLETES the expected task set — exactly when
    the online fleet supervisor fed it to the controller, so online and
    replayed decision sequences match byte-for-byte.  Requires
    ``expected_tasks``; rows left incomplete (in flight, or crash-torn) are
    dropped.

    ``expected_tasks`` (the suite's task names) drops observations missing
    any expected task's row: a partially-recorded step (crash between a
    suite's task rows) was never observed by the online controller, so
    replaying it — even when the surviving rows happen to satisfy the
    metric spec — would diverge EMA/patience/ranking state from the
    crash-free run.  The step re-validates and re-records in full.

    ``with_context=True`` returns ``(step, flat, context)`` triples, where
    ``context`` is the provenance payload the online controller attached to
    its events (``{"engine", "score_dtype"}`` — plus ``"worker_id"`` when
    the rows carry fleet attribution — joined across the group's rows
    exactly like :class:`~repro_torch.core.suite.SuiteResult` joins them) — or
    ``None`` when no row in the group carries any of those keys, so
    replaying a pre-provenance ledger emits byte-identical events."""
    out: List[Tuple[int, Dict[str, float], set, list]] = []

    def absorb(bucket, row):
        _, flat, tasks, raws = bucket
        task = str(row.get("task", "default"))
        tasks.add(task)
        raws.append(row)
        for m, v in row.get("metrics", {}).items():
            if task == "default":
                flat[m] = v
            flat[f"{task}:{m}"] = v

    if group == "consecutive":
        for row in rows:
            if "kind" in row:       # fleet claim records (workqueue schema)
                continue            # are not observations
            step = int(row["step"])
            if not out or out[-1][0] != step:
                out.append((step, {}, set(), []))
            absorb(out[-1], row)
        if expected_tasks is not None:
            expected = set(expected_tasks)
            out = [g for g in out if expected <= g[2]]
    elif group == "completion":
        if expected_tasks is None:
            raise ValueError(
                "group='completion' needs expected_tasks: completion of a "
                "step is defined by the suite's task set")
        expected = set(expected_tasks)
        acc: Dict[int, tuple] = {}          # step -> in-flight bucket
        for row in rows:
            if "kind" in row:
                continue
            step = int(row["step"])
            bucket = acc.setdefault(step, (step, {}, set(), []))
            absorb(bucket, row)
            if expected <= bucket[2]:
                # this row completed the step: the observation lands HERE,
                # in completion order; a later re-validation of the step
                # starts a fresh bucket (a second observation, like the
                # consecutive path's re-record handling)
                out.append(acc.pop(step))
    else:
        raise ValueError(f"unknown grouping {group!r} "
                         "(consecutive | completion)")
    if not with_context:
        return [(step, flat) for step, flat, _, _ in out]

    def join(values: set) -> str:
        return values.pop() if len(values) == 1 else ",".join(sorted(values))

    result = []
    for step, flat, _, raws in out:
        ctx = None
        if any("engine" in r or "score_dtype" in r or "worker_id" in r
               for r in raws):
            ctx = {"engine": join({str(r.get("engine", "")) for r in raws}),
                   "score_dtype": join({str(r.get("score_dtype", "f32"))
                                        for r in raws})}
            if any("worker_id" in r for r in raws):
                # fleet attribution: absent from pre-fleet rows, so ledgers
                # without it keep emitting byte-identical events
                ctx["worker_id"] = join({str(r.get("worker_id", ""))
                                         for r in raws})
            if any("handoff" in r for r in raws):
                # hand-off provenance: ledgered only on snapshot-scored
                # rows, so pre-handoff ledgers replay byte-identically
                ctx["handoff"] = join({str(r.get("handoff", "durable"))
                                       for r in raws})
        result.append((step, flat, ctx))
    return result


def metric_mode(spec: str) -> str:
    """``"min"`` when every term is an AverageRank-style lower-is-better
    series, else ``"max"`` (weighted aggregates mixing directions flip signs
    via negative weights instead)."""
    parsed = spec if isinstance(spec, MetricSpec) else MetricSpec.parse(spec)
    def base(key: str) -> str:
        return key.rsplit(":", 1)[-1]
    return "min" if all(base(k).lower().startswith("averagerank")
                        for k in parsed.keys()) else "max"
