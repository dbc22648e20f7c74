"""AsyncValidator — the paper's contribution: validation decoupled from training.

Watches the checkpoint directory, validates every new committed checkpoint
and reports metrics; training never blocks on it.  Every completed
validation is appended to a ledger file (schema v2: one row per step and
task, with the JAX package's keys), so a restarted validator skips ledgered
steps.

This is the solo path of ``repro/core/validator.py``; the fleet work queue,
the snapshot hand-off, the control plane and telemetry wait for later
slices of the port.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.jsonl import append_jsonl_atomic, read_jsonl_tolerant
from repro_torch.core.reporting import BaseLogger
from repro_torch.core.suite import (SuiteResult, ValidationResult,
                                    params_from_checkpoint)
from repro_torch.core.watcher import CheckpointWatcher, Policy


class ErrorRing:
    """Bounded fault list: keeps the newest ``maxlen`` faults and counts the
    overflow in ``dropped``.  Supports ``append``, ``len``, iteration,
    indexing and truthiness."""

    def __init__(self, maxlen: int = 256):
        self.maxlen = int(maxlen)
        self.dropped = 0
        self._ring: collections.deque = collections.deque(maxlen=self.maxlen)

    def append(self, item) -> None:
        if len(self._ring) == self.maxlen:
            self.dropped += 1
        self._ring.append(item)

    def __len__(self) -> int:
        return len(self._ring)

    def __iter__(self) -> Iterator:
        return iter(list(self._ring))

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self._ring)[i]
        return self._ring[i]

    def __bool__(self) -> bool:
        return bool(self._ring)

    def __repr__(self) -> str:
        return (f"ErrorRing({list(self._ring)!r}, maxlen={self.maxlen}, "
                f"dropped={self.dropped})")


class ValidationLedger:
    """Append-only record of validated (step, task) pairs.

    Schema v2: one JSONL row per (step, task) with the keys ``step``,
    ``task``, ``metrics``, ``timings``, ``subset_size``, ``engine`` and
    ``score_dtype`` — the JAX package's rows, so either package's tools can
    read the other's ledger.  Rows without ``"task"`` (schema v1) load as
    task ``"default"``; records with a ``"kind"`` key (fleet claim records)
    are skipped.  A torn final line (a crash mid-append) is dropped on load;
    a torn line elsewhere raises.  ``expected_tasks`` defines completion: a
    step counts as validated only when every expected task has a row."""

    def __init__(self, path: Optional[str],
                 expected_tasks: Optional[Sequence[str]] = None):
        self.path = path
        self.expected_tasks: Optional[Tuple[str, ...]] = \
            tuple(expected_tasks) if expected_tasks is not None else None
        self._lock = threading.Lock()
        self._rows: List[Optional[dict]] = []
        self._index: Dict[Tuple[int, str], int] = {}
        self._by_step: Dict[int, set] = {}
        if path and os.path.exists(path):
            rows, _ = read_jsonl_tolerant(path, kind="ledger row")
            for rec in rows:
                if "kind" not in rec:
                    self._ingest(rec)

    def _ingest(self, rec: dict) -> None:
        step = int(rec["step"])
        task = str(rec.get("task", "default"))
        rec = {**rec, "step": step, "task": task}
        key = (step, task)
        if key in self._index:
            # a re-validated step supersedes its stale row
            self._rows[self._index[key]] = None
        self._index[key] = len(self._rows)
        self._rows.append(rec)
        self._by_step.setdefault(step, set()).add(task)

    def _completed(self, step: int) -> bool:
        tasks = self._by_step.get(step)
        if not tasks:
            return False
        if self.expected_tasks is None:
            return True
        return all(t in tasks for t in self.expected_tasks)

    def completed(self, step: int) -> bool:
        with self._lock:
            return self._completed(step)

    def __contains__(self, step: int) -> bool:
        return self.completed(step)

    @property
    def validated_steps(self) -> List[int]:
        with self._lock:
            return sorted(s for s in self._by_step if self._completed(s))

    def rows(self) -> List[dict]:
        """Snapshot of the live rows in record order."""
        with self._lock:
            return [dict(rec) for rec in self._rows if rec is not None]

    def record(self, result) -> None:
        """Append one row per task of a :class:`SuiteResult` (consecutively)
        or the one row of a :class:`ValidationResult`; the append is one
        atomic, fsync'd write."""
        results = list(result.tasks.values()) \
            if isinstance(result, SuiteResult) else [result]
        recs = [{"step": r.step, "task": str(r.task),
                 "metrics": r.metrics, "timings": r.timings,
                 "subset_size": r.subset_size, "engine": r.engine,
                 "score_dtype": str(r.score_dtype)} for r in results]
        with self._lock:
            for rec in recs:
                self._ingest(rec)
            if self.path:
                append_jsonl_atomic(self.path, recs)


class ValidatorWorker:
    """Executes whole-checkpoint validation: restore -> every suite task ->
    ledger rows.  The params are restored with ``template`` (default:
    ``{"params": <the suite encoder's parameter shapes>}``, the layout the
    trainer saves) and cached, so a step restores once."""

    def __init__(self, ckpt_root: str, pipeline, *,
                 ledger: Optional[ValidationLedger] = None,
                 logger: Optional[BaseLogger] = None,
                 params_extractor: Callable = params_from_checkpoint,
                 template: Optional[dict] = None,
                 engine: Any = None, max_errors: int = 256):
        self.ckpt_root = ckpt_root
        self.pipeline = pipeline
        self.logger = logger
        self.params_extractor = params_extractor
        self.template = template if template is not None \
            else {"params": pipeline.spec.param_shapes}
        self.engine = engine
        expected = tuple(getattr(pipeline, "task_names", ())
                         or ("default",))
        self.ledger = ledger if ledger is not None \
            else ValidationLedger(None, expected_tasks=expected)
        self.errors = ErrorRing(max_errors)
        self._params_step: Optional[int] = None
        self._params: Any = None

    def load_params(self, step: int):
        if self._params_step != step:
            state, _ = ckpt.restore(self.ckpt_root, step,
                                    template=self.template)
            self._params = self.params_extractor(state)
            self._params_step = step
        return self._params

    def invalidate_params_cache(self) -> None:
        self._params_step = None
        self._params = None

    def log_result(self, result) -> None:
        if self.logger is None:
            return
        logmet = getattr(result, "log_metrics", result.metrics)
        self.logger.log(result.step,
                        {**logmet, **result.timings,
                         "subset_size": result.subset_size,
                         "engine": result.engine,
                         "score_dtype": result.score_dtype})

    def run_step(self, step: int):
        """Restore, run every suite task, append the ledger rows.  Raises on
        failure with nothing recorded."""
        params = self.load_params(step)
        try:
            result = self.pipeline.validate_params(params, step=step,
                                                   engine=self.engine)
        except BaseException:
            self.invalidate_params_cache()
            raise
        self.ledger.record(result)
        return result


class AsyncValidator:
    """Watches ``ckpt_root`` and validates every committed checkpoint.

    ``pipeline`` is a :class:`~repro_torch.core.suite.ValidationSuite` (or
    anything with ``validate_params(params, step=, engine=)``, ``spec`` and
    ``task_names``).  A validation that raises is recorded in ``errors``
    and retried on a later poll, up to ``max_retries`` times: validation
    must never take training down."""

    def __init__(self, ckpt_root: str, pipeline, *,
                 logger: Optional[BaseLogger] = None,
                 policy: Optional[Policy] = None,
                 max_num_valid: Optional[int] = None,
                 ledger_path: Optional[str] = None,
                 poll_interval_s: float = 0.2,
                 params_extractor: Callable = params_from_checkpoint,
                 template: Optional[dict] = None,
                 engine: Any = None, max_retries: int = 2):
        self.ckpt_root = ckpt_root
        self.watcher = CheckpointWatcher(ckpt_root, policy=policy)
        self.max_num_valid = max_num_valid
        expected = tuple(getattr(pipeline, "task_names", ()) or ("default",))
        self.worker = ValidatorWorker(
            ckpt_root, pipeline,
            ledger=ValidationLedger(ledger_path, expected_tasks=expected),
            logger=logger, params_extractor=params_extractor,
            template=template, engine=engine)
        self.poll_interval_s = poll_interval_s
        self.results: List[ValidationResult] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.errors = self.worker.errors
        self.max_retries = max_retries
        self._failures: Dict[int, int] = {}

    @property
    def ledger(self) -> ValidationLedger:
        return self.worker.ledger

    def validate_pending(self) -> int:
        return self._validate(self.watcher.poll())

    def _validate(self, steps) -> int:
        n = 0
        for step in steps:
            if self.max_num_valid is not None \
                    and len(self.results) >= self.max_num_valid:
                break
            if step in self.ledger:
                continue
            try:
                result = self.worker.run_step(step)
            except Exception as e:      # validation must never kill training
                self.errors.append((step, repr(e)))
                n_fail = self._failures.get(step, 0) + 1
                self._failures[step] = n_fail
                if n_fail <= self.max_retries:
                    self.watcher.requeue(step)
                else:
                    self.watcher.mark_seen(step)
                continue
            self._failures.pop(step, None)
            self.results.append(result)
            self.watcher.policy.observe_latency(
                float(result.timings.get("total_s", 0.0)))
            self.worker.log_result(result)
            n += 1
        return n

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("validator already started")

        def loop():
            while not self._stop.is_set():
                self.validate_pending()
                if self.max_num_valid is not None \
                        and len(self.results) >= self.max_num_valid:
                    return
                self._stop.wait(self.poll_interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self, *, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Signal shutdown; with ``drain`` validate whatever is committed."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                self.errors.append(("stop", f"loop still running after "
                                            f"{timeout}s"))
                return
            self._thread = None
        if drain:
            self.validate_pending()

    def validate_all_existing(self) -> List[ValidationResult]:
        """The paper's single-GPU mode: validate what is committed now."""
        self.validate_pending()
        return self.results

    def protect_set(self) -> set:
        """Committed steps not yet validated and not policy-skipped: the
        ones checkpoint GC must keep."""
        committed = set(ckpt.list_steps(self.ckpt_root))
        return committed - set(self.ledger.validated_steps) \
            - self.watcher.skipped
