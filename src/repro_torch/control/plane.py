"""ControlPlane — the asynchronous feedback half of Asyncval, in one object
(``repro/control/plane.py``).

Without it the data path is one-way: trainer -> checkpoints -> validator ->
ledger.  The control plane closes the loop without ever putting validation
on the training hot path:

    ledger row --> CheckpointSelector --> quality-aware GC (top-k ∪ protect)
               --> EarlyStopController --> atomic STOP marker (trainer polls)
               --> (after stop) greedy/uniform checkpoint soup -->
                   virtual checkpoint, re-validated via the normal path

It plugs into ``AsyncValidator(controller=...)``: the validator invokes
``on_result`` after every ledger append (on the validator thread — the
trainer never sees it).  The trainer's only coupling is the STOP marker file
and the optional ``note_train`` feed of train losses (for the overfit
detector's train-vs-validation gap trend).

Every decision is an event in a :class:`ControlEventLog`;
:func:`replay_ledger` re-derives the full decision sequence offline from
validation-ledger rows alone — byte-identical, which makes control policies
testable without ever running a trainer.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.control.earlystop import (EarlyStopConfig,
                                           EarlyStopController)
from repro_torch.control.ensemble import (greedy_soup, materialize_virtual,
                                          uniform_soup)
from repro_torch.control.events import ControlEventLog
from repro_torch.control.metricspec import flatten_rows
from repro_torch.control.selection import CheckpointSelector, \
    SelectionConfig


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    metric: str = "MRR@10"         # a composite spec: "m", "task:m", or a
                                   # weighted "w1*task:m + ..." aggregate
                                   # over a multi-task suite's flat metrics
    mode: str = "max"              # max | min (is bigger better?)
    keep_top_k: int = 0            # 0 = quality-aware GC disabled
    ema: float = 0.0               # selection smoothing (0 = off)
    early_stop: bool = False
    patience: int = 3
    min_delta: float = 0.0
    overfit_window: int = 0        # >= 3 enables the overfit detector
    overfit_min_slope: float = 0.0
    ensemble_top_k: int = 0        # 0 = ensembling disabled
    ensemble_greedy: bool = True   # greedy metric-guided vs uniform soup

    @property
    def ranking_depth(self) -> int:
        return max(self.keep_top_k, self.ensemble_top_k, 1)


class ControlPlane:
    def __init__(self, ckpt_root: Optional[str], cfg: ControlConfig, *,
                 stop_path: Optional[str] = None,
                 event_path: Optional[str] = None,
                 telemetry=None,
                 durability: Optional[Callable[[int], str]] = None):
        self.ckpt_root = ckpt_root
        self.cfg = cfg
        # lazy hand-off durability gate: ``durability(step)`` reports
        # "pending" | "durable" | "failed" (SnapshotChannel.durability is
        # the canonical source; default falls back to the COMMIT marker).
        # DECISIONS (selection, early stop) act on snapshot-scored rows
        # immediately — they are reversible observations; ACTUATIONS that
        # destroy state (quality GC here; soup/promotion already require a
        # committed checkpoint to read) are deferred while any observed
        # snapshot-scored step is still pending.  Actuations are excluded
        # from events.decisions(), so deferral never breaks replay parity.
        self.durability = durability
        self._gc_hold: set = set()
        self._gc_validator: Any = None
        # observation only (decision latency, `selected` lifecycle events);
        # the decision path itself stays clock-free so replay_ledger — which
        # constructs planes without telemetry — re-derives identical events.
        self.telemetry = telemetry
        self.events = ControlEventLog(event_path)
        self.selector = CheckpointSelector(
            SelectionConfig(metric=cfg.metric, mode=cfg.mode,
                            top_k=cfg.ranking_depth, ema=cfg.ema),
            event_log=self.events)
        self.earlystop: Optional[EarlyStopController] = None
        if cfg.early_stop:
            self.earlystop = EarlyStopController(
                EarlyStopConfig(metric=cfg.metric, mode=cfg.mode,
                                patience=cfg.patience,
                                min_delta=cfg.min_delta,
                                overfit_window=cfg.overfit_window,
                                overfit_min_slope=cfg.overfit_min_slope),
                stop_path=stop_path, event_log=self.events)
        self._train_lock = threading.Lock()
        self._train_steps: List[int] = []          # sorted
        self._train_loss: Dict[int, float] = {}
        self.ensemble_step: Optional[int] = None
        self.ensemble_members: List[int] = []

    # -- train-side feed (overfit detector input) ---------------------------
    def note_train(self, step: int, metrics: Dict[str, Any]) -> None:
        """Record a train-loop loss (called from the trainer's metrics hook;
        thread-safe, never blocks on validation state)."""
        if "loss" not in metrics:
            return
        with self._train_lock:
            if step not in self._train_loss:
                bisect.insort(self._train_steps, step)
            self._train_loss[step] = float(metrics["loss"])

    def train_loss_for(self, step: int) -> Optional[float]:
        """Latest train loss at or before ``step`` (pure given the feed)."""
        with self._train_lock:
            i = bisect.bisect_right(self._train_steps, step)
            if i == 0:
                return None
            return self._train_loss[self._train_steps[i - 1]]

    # -- decision path (pure; shared by online + offline replay) ------------
    def observe(self, step: int, metrics: Dict[str, float],
                context: Optional[dict] = None) -> None:
        tel = self.telemetry
        if tel is None:
            return self._observe(step, metrics, context)
        # time the decision from OUTSIDE the fold body: the fold itself
        # stays clock-free, so a replay plane (never given telemetry)
        # re-derives identical decisions and events
        before = self.selector.best_step
        t0 = time.perf_counter()
        self._observe(step, metrics, context)
        tel.metrics.histogram("control.decision_s").observe(
            time.perf_counter() - t0)
        after = self.selector.best_step
        if after != before:
            tel.event("selected", step=after, prev=before, observed=step)

    def _observe(self, step: int, metrics: Dict[str, float],
                 context: Optional[dict] = None) -> None:
        decision = self.selector.observe(step, metrics, context=context)
        if self.earlystop is not None:
            # early stopping judges the SAME (EMA-smoothed) series the
            # selector ranks by — with cfg.ema a raw noise spike must not
            # reset patience or fake an overfit trend.
            smoothed = {**metrics, self.cfg.metric: decision["value"]}
            self.earlystop.observe(step, smoothed,
                                   train_loss=self.train_loss_for(step))

    @property
    def stopped(self) -> bool:
        return self.earlystop is not None and self.earlystop.stopped

    def rehydrate(self, rows, expected_tasks=None,
                  group: str = "consecutive") -> int:
        """Warm the selector's ranking from a previous session's
        validation-ledger rows (``ValidationLedger.rows()``).
        ``expected_tasks`` (the suite's task names) drops partially-recorded
        steps — rows a crash left incomplete — which the online controller
        never observed and which will re-validate in full.

        Restart safety for quality-aware GC: the ledger makes validation
        idempotent (old steps are never re-validated), so without this a
        fresh selector would rank only the new session's steps and GC the
        previous session's best checkpoints.  Per-task (schema-v2) rows are
        grouped back into per-step observations (``group="completion"`` for
        fleet ledgers, where workers interleave steps — see
        :func:`~repro_torch.control.metricspec.flatten_rows`).  Early
        stopping is NOT rehydrated — a stop verdict must come from evidence
        this session gathers (a continued run deliberately gets fresh
        patience)."""
        n = 0
        for step, flat, ctx in flatten_rows(rows, expected_tasks,
                                            with_context=True, group=group):
            try:
                self.selector.observe(step, flat, context=ctx)
            except KeyError:
                # without expected_tasks a partially-recorded step can
                # still surface here, missing the metric the spec needs;
                # online, the controller never saw it — the validator will
                # re-validate and re-observe it, so skip rather than
                # poison startup.
                continue
            n += 1
        return n

    # -- validator hook (decisions + actuations) ----------------------------
    def on_result(self, result: Any, validator: Any = None) -> None:
        """AsyncValidator post-record hook (runs on the validator thread)."""
        # provenance attached to the decision event exactly as the ledger
        # rows record it, so offline replay re-derives the same payload
        context = {"engine": str(getattr(result, "engine", "")),
                   "score_dtype": str(getattr(result, "score_dtype",
                                              "f32"))}
        wid = str(getattr(result, "worker_id", "") or "")
        if wid:
            # fleet attribution, keyed only when present — exactly like the
            # ledger rows, so replay re-derives the same event payloads
            context["worker_id"] = wid
        hand = str(getattr(result, "handoff", "") or "")
        if hand and hand != "durable":
            # hand-off provenance, keyed only for snapshot-scored rows —
            # mirroring the ledger's omitted-when-durable discipline
            context["handoff"] = hand
        self.observe(result.step, result.metrics, context=context)
        if self.cfg.keep_top_k > 0 and self.ckpt_root and validator is not None:
            self._gc_validator = validator
            self.hold_gc_until_durable(result.step, hand)
            self.maybe_gc(validator)

    def hold_gc_until_durable(self, step: int, handoff: str = "") -> bool:
        """Register a GC hold when ``step``'s evidence is snapshot-scored
        and its durable commit hasn't landed: deleting OTHER checkpoints on
        its say-so is irreversible, so GC waits for the step's COMMIT (or
        its failure).  Returns True when a hold was taken."""
        if "snapshot" in str(handoff).split(",") \
                and self._durable_state(step) == "pending":
            self._gc_hold.add(step)
            return True
        return False

    def _durable_state(self, step: int) -> str:
        """``"pending" | "durable" | "failed"`` for ``step`` — the wired
        ``durability`` callable when present, else the COMMIT marker."""
        if self.durability is not None:
            return str(self.durability(step))
        if self.ckpt_root is None:
            return "durable"
        return "durable" if ckpt.is_committed(
            ckpt._step_dir(self.ckpt_root, step)) else "pending"

    def maybe_gc(self, validator: Any = None) -> bool:
        """Run quality-aware GC unless a snapshot-scored step it would act
        on is still awaiting its durable commit.  Holds resolve on either
        outcome — DURABLE (the evidence persisted) or FAILED (the step's
        checkpoint will never exist; nothing to protect-by-deferral).
        Returns True when GC actually ran."""
        validator = validator if validator is not None \
            else self._gc_validator
        if self.cfg.keep_top_k <= 0 or not self.ckpt_root \
                or validator is None:
            return False
        self._gc_hold = {s for s in self._gc_hold
                         if self._durable_state(s) == "pending"}
        if self._gc_hold:
            return False
        self.selector.gc(self.ckpt_root,
                         protect=validator.protect_set(),
                         k=self.cfg.keep_top_k)
        return True

    # -- ensemble (after training stopped / drained) ------------------------
    def build_ensemble(self, score_fn: Callable[[Any], float], *,
                       template: Any,
                       step: Optional[int] = None) -> Optional[int]:
        """Soup the top-k ranked checkpoints into a committed virtual
        checkpoint; returns its step (None if ensembling is disabled or
        fewer than two members are rankable).  ``template`` is the key-path
        template the members are restored with (the validator's:
        ``validator.worker.template``)."""
        if self.cfg.ensemble_top_k <= 0 or not self.ckpt_root:
            return None
        ranked = self.selector.top_steps(self.cfg.ensemble_top_k)
        # only checkpoints still on disk can be souped: when the ranking
        # runs deeper than the retention budget (ensemble_top_k >
        # keep_top_k), quality-aware GC has already deleted the tail.
        # Filtered here in the actuation layer — the selector's decision
        # state must not depend on filesystem effects, or offline replay
        # would diverge.
        available = set(ckpt.list_steps(self.ckpt_root))
        ranked = [s for s in ranked if s in available]
        if len(ranked) < 2:
            return None
        if self.cfg.ensemble_greedy:
            params, members, score = greedy_soup(
                self.ckpt_root, ranked, score_fn, template=template,
                mode=self.cfg.mode)
        else:
            params = uniform_soup(self.ckpt_root, ranked, template)
            members, score = list(ranked), float(score_fn(params))
        vstep = materialize_virtual(self.ckpt_root, params, members=members,
                                    step=step)
        self.ensemble_step, self.ensemble_members = vstep, members
        self.events.emit("ensemble", vstep, members=members, score=score,
                         greedy=self.cfg.ensemble_greedy)
        return vstep


def replay_ledger(rows, cfg: ControlConfig, *, train_history=None,
                  expected_tasks=None,
                  group: str = "consecutive") -> ControlPlane:
    """Offline replay: re-derive the decision sequence from validation-ledger
    rows (``ValidationLedger.rows()``, insertion order).

    Returns a plane whose ``events.decisions()`` is identical to the online
    run's — no filesystem access, no markers, no deletions.
    ``train_history``: optional ``[(step, loss), ...]`` feed for the overfit
    detector (the trainer's logged losses).  ``expected_tasks``: the suite's
    task names, to drop crash-torn partial steps the online controller
    never observed.  ``group="completion"`` replays a FLEET ledger, where
    workers interleave rows across steps and an observation happens when a
    step's last expected task row lands (the supervisor's feed order)."""
    plane = ControlPlane(None, cfg, stop_path=None, event_path=None)
    for step, loss in (train_history or []):
        plane.note_train(step, {"loss": loss})
    for step, flat, ctx in flatten_rows(rows, expected_tasks,
                                        with_context=True, group=group):
        try:
            plane.observe(step, flat, context=ctx)
        except KeyError:
            continue          # partial step (crash between task rows): the
            #                   online controller never observed it either
    return plane
