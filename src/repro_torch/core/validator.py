"""AsyncValidator — the paper's contribution: validation decoupled from training.

Watches the checkpoint directory, validates every new committed checkpoint
and reports metrics; training never blocks on it.  Every completed
validation is appended to a ledger file (schema v2: one row per step and
task, with the JAX package's keys), so a restarted validator skips ledgered
steps.

The port of ``repro/core/validator.py``: the solo validator with its
telemetry hooks (spans, the checkpoint-to-verdict histogram; observation
only: the ledger's bytes are the same with telemetry on and off), the
control-plane hook (``controller=``, :class:`repro_torch.control.
ControlPlane`) and the lazy snapshot hand-off (``snapshots=``,
:mod:`repro_torch.handoff`), and the fleet worker: a
:class:`ValidatorWorker` with a :class:`~repro_torch.core.workqueue.
WorkQueue` claims (step, task) units from the shared ledger, heartbeats
its lease while the engine runs, appends the result row and completes the
unit (:meth:`ValidatorWorker.run_once`, :meth:`ValidatorWorker.
run_forever`).  On a CUDA device the validation loop of a started
:class:`AsyncValidator` and the claim loop of every worker run on a CUDA
stream of their own, so their kernels (and the upload of a snapshot's or
a restored checkpoint's params) can overlap a trainer's, or another
worker's, on the same card, and their clock reads wait for their own work
only (``engine.synchronize`` waits on the current stream).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.jsonl import append_jsonl_atomic, read_jsonl_tolerant
from repro_torch.core.reporting import BaseLogger
from repro_torch.core.suite import (SuiteResult, ValidationResult,
                                    params_from_checkpoint)
from repro_torch.core.watcher import CheckpointWatcher, Policy
from repro_torch.core.workqueue import WorkQueue, WorkUnit

CKPT_TO_VERDICT_METRIC = "validate.ckpt_to_verdict_s"


class ErrorRing:
    """Bounded fault list: keeps the newest ``maxlen`` faults and counts the
    overflow in ``dropped`` (mirrored to a bound counter, the
    ``validator.errors_dropped`` instrument under telemetry).  Supports
    ``append``, ``len``, iteration, indexing and truthiness."""

    def __init__(self, maxlen: int = 256):
        self.maxlen = int(maxlen)
        self.dropped = 0
        self._ring: collections.deque = collections.deque(maxlen=self.maxlen)
        self._counter = None        # repro_torch.obs.metrics.Counter

    def bind_counter(self, counter) -> None:
        if self.dropped and counter is not None:
            counter.inc(self.dropped)   # count drops from before binding
        self._counter = counter

    def append(self, item) -> None:
        if len(self._ring) == self.maxlen:
            self.dropped += 1
            if self._counter is not None:
                self._counter.inc()
        self._ring.append(item)

    def clear(self) -> None:
        self._ring.clear()

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
    ``score_dtype``, then ``"worker_id"`` on a row a fleet worker scored
    and ``"handoff": "snapshot"`` on a row scored from a pre-durable
    snapshot (a solo validator's durable rows carry neither key) — the JAX
    package's rows, so either package's tools can read the other's
    ledger.  Rows
    without ``"task"`` (schema v1) load as task ``"default"``; records
    with a ``"kind"`` key (fleet claim records) are skipped.  A torn final
    line (a crash mid-append) is dropped on load; a torn line elsewhere
    raises.  ``expected_tasks`` defines completion: a
    step counts as validated only when every expected task has a row.
    With ``telemetry``, each append runs inside a ``recorded`` span; the
    bytes written are the same."""

    def __init__(self, path: Optional[str],
                 expected_tasks: Optional[Sequence[str]] = None,
                 telemetry=None):
        self.path = path
        self.telemetry = telemetry
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

    def tasks_for(self, step: int) -> List[str]:
        with self._lock:
            return sorted(self._by_step.get(step, ()))

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
        recs = []
        for r in results:
            rec = {"step": r.step, "task": str(r.task),
                   "metrics": r.metrics, "timings": r.timings,
                   "subset_size": r.subset_size, "engine": r.engine,
                   "score_dtype": str(r.score_dtype)}
            wid = str(getattr(r, "worker_id", "") or "")
            if wid:
                rec["worker_id"] = wid
            if getattr(r, "handoff", "") == "snapshot":
                rec["handoff"] = "snapshot"
            recs.append(rec)
        tel = self.telemetry
        with self._lock:
            for rec in recs:
                self._ingest(rec)
            if self.path:
                if tel is None:
                    append_jsonl_atomic(self.path, recs)
                else:
                    with tel.span("recorded", step=recs[0]["step"],
                                  task=recs[0]["task"], n_rows=len(recs)):
                        append_jsonl_atomic(self.path, recs)


class ValidatorWorker:
    """Executes validation work, the fleet's unit of scale.  Two modes share
    one execution body, so solo and fleet validation are the same code:

      * whole-step (:meth:`run_step`): restore -> every suite task ->
        ledger rows; the solo :class:`AsyncValidator` runs on this.
      * fleet (:meth:`run_once` / :meth:`run_forever`): claim one
        (step, task) unit from the shared ``queue``, renew its lease every
        ``heartbeat_interval_s`` while the engine runs, append the result
        row, complete the unit.  A failed unit is abandoned so a peer
        retries it; the queue's abandon count (derived from the ledger) is
        the fleet's retry budget.

    The params are restored with ``template`` (default: ``{"params": <the
    suite encoder's parameter shapes>}``, the layout the trainer saves) and
    cached, so the units of one step restore once.  ``worker_id`` (default:
    the queue's) stamps every row this worker records; empty, the rows
    carry no ``worker_id`` key.

    ``snapshots`` (a :class:`~repro_torch.handoff.SnapshotChannel` or
    :class:`~repro_torch.handoff.SnapshotSpool`: anything with
    ``get(step)``) is consulted before the durable restore, so a step can be
    scored while its ``ckpt.save`` is still running; its rows then carry
    ``handoff="snapshot"``.

    On a CUDA device :meth:`run_once` runs on the worker's own CUDA stream,
    so two workers on two threads of one process never wait on each
    other's work."""

    def __init__(self, ckpt_root: str, pipeline, *,
                 ledger: Optional[ValidationLedger] = None,
                 queue: Optional[WorkQueue] = None,
                 logger: Optional[BaseLogger] = None,
                 params_extractor: Callable = params_from_checkpoint,
                 template: Optional[dict] = None,
                 engine: Any = None, worker_id: str = "",
                 heartbeat_interval_s: float = 0.25, telemetry=None,
                 max_errors: int = 256, snapshots: Any = None):
        self.ckpt_root = ckpt_root
        self.pipeline = pipeline
        self.queue = queue
        self.snapshots = snapshots
        self.logger = logger
        self.params_extractor = params_extractor
        self.template = template if template is not None \
            else {"params": pipeline.spec.param_shapes}
        self.engine = engine
        self.worker_id = str(worker_id
                             or (queue.worker_id if queue is not None
                                 else ""))
        self.heartbeat_interval_s = heartbeat_interval_s
        expected = tuple(getattr(pipeline, "task_names", ())
                         or ("default",))
        self.ledger = ledger if ledger is not None \
            else ValidationLedger(None, expected_tasks=expected,
                                  telemetry=telemetry)
        self.telemetry = telemetry
        self.errors = ErrorRing(max_errors)
        if telemetry is not None:
            self.errors.bind_counter(
                telemetry.metrics.counter("validator.errors_dropped"))
            if self.ledger.telemetry is None:
                self.ledger.telemetry = telemetry
        self.completed: List[WorkUnit] = []
        self._params_step: Optional[int] = None
        self._params: Any = None
        self._params_handoff = ""   # "snapshot" | "" for the cached params
        self._stream: Optional[torch.cuda.Stream] = None

    def load_params(self, step: int):
        if self._params_step != step:
            snap = self.snapshots.get(step) \
                if self.snapshots is not None else None
            if snap is not None:
                # the tree the durable restore would give, from host memory
                self._params = self.params_extractor(snap.state())
                self._params_handoff = "snapshot"
            else:
                state, _ = ckpt.restore(self.ckpt_root, step,
                                        template=self.template)
                self._params = self.params_extractor(state)
                self._params_handoff = ""
            self._params_step = step
        return self._params

    @property
    def last_handoff(self) -> str:
        """``"snapshot"`` when the cached params came from the hand-off,
        ``""`` for a durable restore."""
        return self._params_handoff

    def invalidate_params_cache(self) -> None:
        """Drop the cached params (on a failed validation: the cached tree
        may be the fault, and the retry must resolve its source again)."""
        self._params_step = None
        self._params = None
        self._params_handoff = ""

    def _stamp(self, result):
        """Mark every row of ``result`` with this worker's id and the
        hand-off route of its params (a no-op for an anonymous worker's
        durable restore: the rows stay byte-identical)."""
        updates = {}
        if self.worker_id:
            updates["worker_id"] = self.worker_id
        if self._params_handoff:
            updates["handoff"] = self._params_handoff
        if not updates:
            return result
        if isinstance(result, SuiteResult):
            return dataclasses.replace(result, tasks={
                n: dataclasses.replace(r, **updates)
                for n, r in result.tasks.items()})
        return dataclasses.replace(result, **updates)

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
            result = self._stamp(self.pipeline.validate_params(
                params, step=step, engine=self.engine))
        except BaseException:
            self.invalidate_params_cache()
            raise
        self.ledger.record(result)
        if self.telemetry is not None:
            self._observe_verdict(step)
        return result

    def _observe_verdict(self, step: int) -> None:
        """Checkpoint-to-verdict latency, from the earliest mark there is:
        ``produced`` (the trainer handed the state to the save path), then
        ``snapshotted``, then ``discovered`` (the watcher's poll), else the
        COMMIT marker's mtime (wall clock).  Metrics only."""
        tel = self.telemetry
        lag = None
        for mark in ("produced", "snapshotted", "discovered"):
            lag = tel.since(mark, step)
            if lag is not None:
                break
        if lag is None:
            marker = os.path.join(ckpt._step_dir(self.ckpt_root, step),
                                  ckpt.COMMIT_MARKER)
            try:
                lag = max(0.0, time.time() - os.path.getmtime(marker))
            except OSError:
                return
        tel.metrics.histogram(CKPT_TO_VERDICT_METRIC).observe(lag)

    # -- fleet claim loop ---------------------------------------------------
    def own_stream(self):
        """The worker's own CUDA stream as a context when the suite's
        encoder runs on a card (a null context otherwise)."""
        spec = getattr(self.pipeline, "spec", None)
        device = getattr(spec, "device", None)
        if device is None or torch.device(device).type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(torch.device(device))
        return torch.cuda.stream(self._stream)

    def execute_unit(self, unit: WorkUnit):
        """Run one claimed (step, task) unit, renewing its lease while the
        engine runs, then record its row and complete it."""
        params = self.load_params(unit.step)
        stop_hb = threading.Event()
        hb = threading.Thread(target=self._heartbeat, args=(unit, stop_hb),
                              daemon=True)
        hb.start()
        try:
            result = self._stamp(self.pipeline.run_unit(
                params, unit, engine=self.engine))
        except BaseException:
            self.invalidate_params_cache()
            raise
        finally:
            stop_hb.set()
            hb.join()
        self.ledger.record(result)
        self.queue.complete(unit)   # after the row: a complete has a result
        if self.telemetry is not None:
            self._observe_verdict(unit.step)
        self.log_result(result)
        self.completed.append(unit)
        return result

    def _heartbeat(self, unit: WorkUnit, stop_evt: threading.Event) -> None:
        while not stop_evt.wait(self.heartbeat_interval_s):
            try:
                self.queue.renew(unit)
            except Exception:   # a failed heartbeat must not kill the run
                pass

    def run_once(self) -> int:
        """One scheduling round: claim and execute at most one unit.
        Returns 1 when a unit completed, else 0 (appending a tick when only
        peers' live leases are left, so a dead peer's lease can age out:
        the ledger's sequence is the clock)."""
        if self.queue is None:
            raise RuntimeError("fleet mode requires a WorkQueue")
        state = self.queue.refresh()
        for unit in state.claimable(self.queue.capabilities):
            if not self.queue.try_claim(unit):
                continue                    # raced a peer and lost
            try:
                with self.own_stream():
                    self.execute_unit(unit)
            except Exception as e:          # release it for a peer to retry
                self.errors.append((unit.step, f"{unit.task}: {e!r}"))
                self.queue.abandon(unit, error=repr(e))
                return 0
            return 1
        if state.blocked():
            self.queue.tick()
        return 0

    def run_forever(self, stop_event: threading.Event, *,
                    idle_wait_s: float = 0.05,
                    drained: Optional[Callable[[], bool]] = None) -> None:
        """Claim loop until ``stop_event`` is set, or ``drained()`` reports
        the backlog empty during an idle round."""
        while not stop_event.is_set():
            if self.run_once() == 0:
                if drained is not None and drained():
                    return
                stop_event.wait(idle_wait_s)


class AsyncValidator:
    """Watches ``ckpt_root`` and validates every committed checkpoint.

    ``pipeline`` is a :class:`~repro_torch.core.suite.ValidationSuite` (or
    anything with ``validate_params(params, step=, engine=)``, ``spec`` and
    ``task_names``).  A validation that raises is recorded in ``errors``
    and retried on a later poll, up to ``max_retries`` times: validation
    must never take training down.  ``telemetry`` (a
    :class:`repro_torch.obs.Telemetry`) reaches the watcher, the worker,
    the ledger and, when the suite's config has none, the suite's engines.

    ``controller`` (an object with ``on_result(result, validator)``, e.g.
    :class:`repro_torch.control.ControlPlane`) runs after every ledger
    append, on the validator's thread; its faults go to ``errors`` and
    never stop validation.  ``snapshots`` (a
    :class:`repro_torch.handoff.SnapshotChannel` or ``SnapshotSpool``):
    pending snapshots are validated before the watcher poll, a publish
    wakes the loop at once, a snapshot that fails validation is discarded
    (the retry restores the durable checkpoint), and a snapshot verdict
    marks the step seen, so the watcher's later discovery of its
    checkpoint validates nothing twice.  ``extra_protect`` (a callable
    returning a set of steps) unions protections from outside validation
    into :meth:`protect_set`: the serving tier's live and promoting
    checkpoints (``Promoter.protect_set``).  ``workqueue`` (a fleet's
    :class:`~repro_torch.core.workqueue.WorkQueue` on the same ledger)
    keeps steps under other workers' live leases out of GC, and
    ``worker_id`` then stamps this validator's rows; without one, the
    ledger's bytes are the solo validator's."""

    def __init__(self, ckpt_root: str, pipeline, *,
                 logger: Optional[BaseLogger] = None,
                 policy: Optional[Policy] = None,
                 max_num_valid: Optional[int] = None,
                 ledger_path: Optional[str] = None,
                 poll_interval_s: float = 0.2,
                 params_extractor: Callable = params_from_checkpoint,
                 template: Optional[dict] = None,
                 engine: Any = None, max_retries: int = 2,
                 controller: Any = None,
                 workqueue: Optional[WorkQueue] = None, worker_id: str = "",
                 telemetry=None, snapshots: Any = None,
                 extra_protect: Optional[Callable[[], set]] = None):
        self.ckpt_root = ckpt_root
        self.telemetry = telemetry
        self.workqueue = workqueue
        self.watcher = CheckpointWatcher(ckpt_root, policy=policy,
                                         telemetry=telemetry)
        self.snapshots = snapshots
        self._wake = threading.Event()
        if snapshots is not None and hasattr(snapshots, "subscribe"):
            snapshots.subscribe(lambda step: self._wake.set())
        self.controller = controller
        self.extra_protect = extra_protect
        self.max_num_valid = max_num_valid
        expected = tuple(getattr(pipeline, "task_names", ()) or ("default",))
        if telemetry is not None:
            if workqueue is not None and workqueue.telemetry is None:
                workqueue.telemetry = telemetry
            # engine spans: thread the handle through the suite's config
            vcfg = getattr(pipeline, "vcfg", None)
            if vcfg is not None \
                    and getattr(vcfg, "telemetry", None) is None:
                vcfg.telemetry = telemetry
        self.worker = ValidatorWorker(
            ckpt_root, pipeline,
            ledger=ValidationLedger(ledger_path, expected_tasks=expected,
                                    telemetry=telemetry),
            queue=workqueue, logger=logger,
            params_extractor=params_extractor, template=template,
            engine=engine, worker_id=worker_id, telemetry=telemetry,
            snapshots=snapshots)
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
        n = self._validate(self._snapshot_pending())
        return n + self._validate(self.watcher.poll())

    def _snapshot_pending(self) -> List[int]:
        """Claim the hand-off's unvalidated snapshots, in publish order;
        ledgered steps are marked validated without a claim, so the channel
        can retire them once durable."""
        if self.snapshots is None:
            return []
        steps = []
        for step in self.snapshots.pending():
            if step in self.ledger:
                self.snapshots.mark_validated(step)
                continue
            if self.snapshots.claim(step) is not None:
                steps.append(step)
        return steps

    def validate_step(self, step: int) -> int:
        """Validate one committed step now, bypassing the watcher policy
        and the ``max_num_valid`` cap (still ledger-idempotent, still
        logged)."""
        self.watcher.mark_seen(step)
        return self._validate([step], ignore_cap=True)

    def _validate(self, steps, *, ignore_cap: bool = False) -> int:
        n = 0
        for step in steps:
            if not ignore_cap and self.max_num_valid is not None \
                    and len(self.results) >= self.max_num_valid:
                break
            if step in self.ledger:
                continue
            try:
                result = self.worker.run_step(step)
            except Exception as e:      # validation must never kill training
                self.errors.append((step, repr(e)))
                if self.snapshots is not None:
                    # drop the (possibly poisoned) host copy: the retry
                    # restores the durable checkpoint once committed
                    self.snapshots.discard(step)
                n_fail = self._failures.get(step, 0) + 1
                self._failures[step] = n_fail
                if n_fail <= self.max_retries:
                    self.watcher.requeue(step)
                else:
                    self.watcher.mark_seen(step)
                continue
            self._failures.pop(step, None)
            if self.snapshots is not None \
                    and self.worker.last_handoff == "snapshot":
                # free the snapshot (once durable) and consume the step's
                # later watcher discovery
                self.snapshots.mark_validated(step)
                self.watcher.mark_seen(step)
            self.results.append(result)
            self.watcher.policy.observe_latency(
                float(result.timings.get("total_s", 0.0)))
            self.worker.log_result(result)
            if self.controller is not None:
                try:
                    self.controller.on_result(result, self)
                except Exception as e:
                    self.errors.append((step, f"controller: {e!r}"))
            n += 1
        return n

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("validator already started")

        def loop():
            # the worker's own stream: with the default stream the loop's
            # kernels would serialise with a trainer's on the same card
            with self.worker.own_stream():
                while not self._stop.is_set():
                    self._wake.clear()
                    self.validate_pending()
                    if self.max_num_valid is not None \
                            and len(self.results) >= self.max_num_valid:
                        return
                    # a snapshot publish (or stop) cuts the sleep short
                    self._wake.wait(self.poll_interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self, *, drain: bool = True,
             drain_timeout: Optional[float] = None) -> None:
        """Signal shutdown; with ``drain`` validate whatever is committed
        (and whatever snapshot is pending).

        ``drain_timeout`` (seconds) bounds the whole shutdown, the loop's
        join and the drain pass, so a wedged engine run cannot hang it: on
        expiry the timeout goes to ``errors`` (key ``"stop"``) and the
        wedged daemon thread is left behind; whatever it ledgers later is
        still idempotent on restart."""
        self._stop.set()
        self._wake.set()                # unblock a loop mid-sleep
        deadline = None if drain_timeout is None \
            else time.monotonic() + drain_timeout
        if self._thread is not None:
            self._thread.join(timeout=drain_timeout)
            if self._thread.is_alive():
                self.errors.append(
                    ("stop", f"drain timed out after {drain_timeout}s "
                             "waiting for the validation loop"))
                self._thread = None
                return
            self._thread = None
        if not drain:
            return
        if deadline is None:
            self.validate_pending()
            return
        t = threading.Thread(target=self._drain_guarded, daemon=True)
        t.start()
        t.join(timeout=max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            self.errors.append(
                ("stop", f"drain timed out after {drain_timeout}s"))

    def _drain_guarded(self) -> None:
        try:
            self.validate_pending()
        except Exception as e:          # surfaced, never raised at shutdown
            self.errors.append(("stop", f"drain: {e!r}"))

    def validate_all_existing(self) -> List[ValidationResult]:
        """The paper's single-GPU mode: validate what is committed now."""
        self.validate_pending()
        return self.results

    def protect_set(self) -> set:
        """The steps checkpoint GC must keep: committed, not yet validated
        and not policy-skipped; with a fleet ``workqueue``, every step
        under a live lease of any worker (a peer may be mid-restore on
        it); plus whatever ``extra_protect`` names."""
        committed = set(ckpt.list_steps(self.ckpt_root))
        protected = committed - set(self.ledger.validated_steps) \
            - self.watcher.skipped
        if self.workqueue is not None:
            protected |= committed & self.workqueue.refresh().claimed_steps()
        if self.extra_protect is not None:
            protected |= set(self.extra_protect())
        return protected
