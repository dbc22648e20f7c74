"""Ledger-driven checkpoint selection: best-so-far, top-k, quality-aware GC
(``repro/control/selection.py``).

``CheckpointSelector`` ranks checkpoints by a chosen validation metric
(optionally EMA-smoothed to de-noise subset validation), keeps best-so-far
and top-k, and drives *quality-aware* retention through
``ckpt.gc_checkpoints(keep=...)``: keep the top-k checkpoints by metric plus
everything the validator still protects, instead of a blind ``keep_last``
window.

Determinism: ranking state is a pure function of the ``observe`` call
sequence.  Ties break toward the LATER step (fresher weights preferred at
equal quality), so replaying a ledger reproduces identical rankings.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.control.events import ControlEventLog
from repro_torch.control.metricspec import MetricSpec, flatten_rows


@dataclasses.dataclass(frozen=True)
class SelectionConfig:
    metric: str = "MRR@10"       # a composite spec: "m", "task:m", or a
                                 # weighted "w1*task:m + w2*task2:m" sum
    mode: str = "max"            # max | min (is bigger better?)
    top_k: int = 3               # ranking depth (also the GC keep budget)
    ema: float = 0.0             # 0 disables; else s_t = ema*s_{t-1} + (1-ema)*x_t

    def __post_init__(self):
        if self.mode not in ("max", "min"):
            raise ValueError(f"mode must be max|min, got {self.mode!r}")
        if not (0.0 <= self.ema < 1.0):
            raise ValueError(f"ema must be in [0, 1), got {self.ema}")
        MetricSpec.parse(self.metric)         # fail fast on a bad spec


class CheckpointSelector:
    def __init__(self, cfg: SelectionConfig,
                 event_log: Optional[ControlEventLog] = None):
        self.cfg = cfg
        self.spec = MetricSpec.parse(cfg.metric)
        self.events = event_log if event_log is not None else ControlEventLog()
        self._raw: Dict[int, float] = {}
        self._value: Dict[int, float] = {}    # smoothed (== raw when ema=0)
        self._ema_state: Optional[float] = None

    # -- ranking ------------------------------------------------------------
    def _key(self, item: Tuple[int, float]):
        step, value = item
        sign = -1.0 if self.cfg.mode == "max" else 1.0
        return (sign * value, -step)          # ties -> later step first

    def ranking(self) -> List[Tuple[int, float]]:
        """(step, smoothed value) best-first."""
        return sorted(self._value.items(), key=self._key)

    def top_steps(self, k: Optional[int] = None) -> List[int]:
        k = self.cfg.top_k if k is None else k
        return [s for s, _ in self.ranking()[:max(k, 0)]]

    @property
    def best_step(self) -> Optional[int]:
        top = self.top_steps(1)
        return top[0] if top else None

    @property
    def best_value(self) -> Optional[float]:
        s = self.best_step
        return None if s is None else self._value[s]

    def value(self, step: int) -> Optional[float]:
        return self._value.get(step)

    # -- ingestion ----------------------------------------------------------
    def observe(self, step: int, metrics: Dict[str, float],
                context: Optional[dict] = None) -> dict:
        """Fold one validation row in (observation order = smoothing order).

        ``context`` is optional provenance (``{"engine", "score_dtype"}``,
        plus ``"handoff"`` for snapshot-scored rows) merged into the
        decision record.  Returns the decision record; also emitted as a
        ``select`` event."""
        step = int(step)
        x = self.spec.value(metrics)
        self._raw[step] = x
        if self.cfg.ema > 0.0:
            prev = self._ema_state if self._ema_state is not None else x
            value = self.cfg.ema * prev + (1.0 - self.cfg.ema) * x
            self._ema_state = value
        else:
            value = x
        prev_best = self.best_step
        self._value[step] = value
        decision = {"value": value, "raw": x,
                    "best_step": self.best_step,
                    "new_best": self.best_step == step
                                and prev_best != step,
                    "top_steps": self.top_steps()}
        if context:
            decision.update(context)
        self.events.emit("select", step, **decision)
        return decision

    def observe_rows(self, rows: Iterable[dict],
                     expected_tasks=None) -> None:
        """Replay validation-ledger rows (``ValidationLedger.rows()``),
        grouped back into per-step observations; a partially-recorded step
        is skipped, as the online controller never observed it."""
        for step, flat, ctx in flatten_rows(rows, expected_tasks,
                                            with_context=True):
            try:
                self.observe(step, flat, context=ctx)
            except KeyError:
                continue

    # -- quality-aware retention --------------------------------------------
    def keep_set(self, protect: Iterable[int] = (),
                 k: Optional[int] = None) -> Set[int]:
        """Top-k by metric ∪ externally protected (unvalidated) steps.

        ``k`` overrides the ranking depth (the plane ranks deeper than it
        retains when ``ensemble_top_k > keep_top_k``)."""
        return set(self.top_steps(k)) | set(protect)

    def gc(self, root: str, protect: Iterable[int] = (),
           k: Optional[int] = None) -> List[int]:
        """Delete committed checkpoints outside :meth:`keep_set`.

        ``protect`` is the validator's ``protect_set()``: committed but
        unvalidated steps are never deletable.  The knowledge horizon
        (newest step this selector has ranked or been told to protect) is
        passed down, so a checkpoint committed mid-decision survives."""
        protect = set(protect)
        keep = self.keep_set(protect, k)
        known = set(self._value) | protect
        deleted = ckpt.gc_checkpoints(root, protect=protect, keep=keep,
                                      horizon=max(known) if known else None)
        self.events.emit("gc", self.best_step if self.best_step is not None
                         else -1, deleted=deleted, kept=sorted(keep))
        return deleted
