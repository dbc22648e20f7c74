"""Early stopping: patience + history-based overfit detection + STOP marker
(``repro/control/earlystop.py``).

The paper's stated purpose for async validation is to "avoid over-fitting
and determine when the model has converged so as to stop training" — this
module is that verdict.  Two detectors, both pure functions of the observed
(step, validation value[, train loss]) sequence:

  * plateau  — classic patience/min-delta: stop after ``patience``
    consecutive evaluations without an improvement of at least ``min_delta``
    over the best seen.
  * overfit  — history-based (Li et al. 2024, "Keeping Deep Learning Models
    in Check"): over a sliding window of the last ``overfit_window``
    evaluations, the validation metric trends *worse* while the train loss
    still trends *down* — the train-vs-validation gap is widening, the
    classic overfit signature that naive patience can miss (a slow bleed
    never trips min_delta).  Trends are least-squares slopes, so a single
    noisy evaluation cannot trigger it.

The verdict is published as an atomic ``STOP`` marker file (tmp + fsync +
rename, same discipline as checkpoint commit): the trainer polls for the
marker between steps and halts — training stops *asynchronously*, it never
blocks on (or even knows about) validation.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

from repro_torch.control.events import ControlEventLog
from repro_torch.control.metricspec import MetricSpec

STOP_MARKER = "STOP"


@dataclasses.dataclass(frozen=True)
class EarlyStopConfig:
    metric: str = "MRR@10"         # a composite spec: "m", "task:m", or a
                                   # weighted "w1*task:m + ..." aggregate
    mode: str = "max"              # max | min (is bigger better?)
    patience: int = 3              # evaluations without improvement
    min_delta: float = 0.0         # improvement below this is noise
    overfit_window: int = 0        # >= 3 enables the overfit detector
    overfit_min_slope: float = 0.0  # val must worsen faster than this/eval

    def __post_init__(self):
        if self.mode not in ("max", "min"):
            raise ValueError(f"mode must be max|min, got {self.mode!r}")
        if self.patience < 1:
            raise ValueError("patience must be >= 1")
        if self.overfit_window == 1 or self.overfit_window == 2:
            raise ValueError("overfit_window needs >= 3 points for a trend")
        MetricSpec.parse(self.metric)          # fail fast on a bad spec


def _slope(ys: List[float]) -> float:
    """Least-squares slope of ys against 0..n-1 (n >= 2)."""
    n = len(ys)
    xm = (n - 1) / 2.0
    ym = sum(ys) / n
    num = sum((i - xm) * (y - ym) for i, y in enumerate(ys))
    den = sum((i - xm) ** 2 for i in range(n))
    return num / den


def write_stop_marker(path: str, verdict: dict) -> None:
    """Atomically publish the stop verdict (tmp + fsync + rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(verdict, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def stop_requested(path: Optional[str]) -> Optional[dict]:
    """The trainer-side poll: verdict dict if a STOP marker exists."""
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {"reason": "unreadable_marker"}


class EarlyStopController:
    def __init__(self, cfg: EarlyStopConfig, *,
                 stop_path: Optional[str] = None,
                 event_log: Optional[ControlEventLog] = None):
        self.cfg = cfg
        self.spec = MetricSpec.parse(cfg.metric)
        self.stop_path = stop_path
        self.events = event_log if event_log is not None else ControlEventLog()
        self.best: Optional[float] = None
        self.best_step: Optional[int] = None
        self.bad_evals = 0
        self.stopped = False
        self.reason: Optional[str] = None
        self.stop_step: Optional[int] = None
        # (step, val value, train loss or None), observation order
        self._history: List[Tuple[int, float, Optional[float]]] = []

    # -- detectors ----------------------------------------------------------
    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.cfg.mode == "max":
            return value > self.best + self.cfg.min_delta
        return value < self.best - self.cfg.min_delta

    def _overfit(self) -> bool:
        w = self.cfg.overfit_window
        if w < 3 or len(self._history) < w:
            return False
        window = self._history[-w:]
        trains = [t for _, _, t in window]
        if any(t is None for t in trains):
            return False                      # gap undefined without train loss
        vals = [v for _, v, _ in window]
        val_slope = _slope(vals)
        train_slope = _slope([float(t) for t in trains])
        worsening = (val_slope < -self.cfg.overfit_min_slope
                     if self.cfg.mode == "max"
                     else val_slope > self.cfg.overfit_min_slope)
        return worsening and train_slope <= 0.0

    # -- ingestion ----------------------------------------------------------
    def observe(self, step: int, metrics: Dict[str, float],
                train_loss: Optional[float] = None) -> bool:
        """Fold one validation row in; returns the (latched) stop verdict."""
        step = int(step)
        value = self.spec.value(metrics)
        self._history.append((step, value,
                              None if train_loss is None
                              else float(train_loss)))
        if self.stopped:                       # latched: drain-time rows
            return True                        # cannot un-stop training
        if self._improved(value):
            self.best, self.best_step = value, step
            self.bad_evals = 0
        else:
            self.bad_evals += 1
        reason = None
        if self._overfit():
            reason = "overfit"
        elif self.bad_evals >= self.cfg.patience:
            reason = "plateau"
        if reason is not None:
            self._trigger(step, reason)
        return self.stopped

    def _trigger(self, step: int, reason: str) -> None:
        self.stopped = True
        self.reason = reason
        self.stop_step = step
        verdict = {"reason": reason, "step": step,
                   "metric": self.cfg.metric, "best_step": self.best_step,
                   "best_value": self.best, "bad_evals": self.bad_evals}
        self.events.emit("stop", step,
                         **{k: v for k, v in verdict.items() if k != "step"})
        if self.stop_path:
            write_stop_marker(self.stop_path, verdict)
            self.events.emit("stop_marker", step, path=self.stop_path)
