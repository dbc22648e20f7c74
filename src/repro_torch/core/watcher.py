"""Checkpoint watcher — the paper's "listen to --ckpts_dir" loop, hardened.

The port of ``repro/core/watcher.py``.  Only directories carrying the
COMMIT marker are visible (two-phase commit, see
:mod:`repro_torch.ckpt.checkpoint`), so a validator polling while the
trainer is mid-write can never read a torn checkpoint.

Scheduling policies (beyond-paper, needed when validation is slower than the
checkpoint cadence at scale):
  * FIFO          — the paper's behaviour: validate every checkpoint in order.
  * LATEST_FIRST  — always jump to the newest checkpoint, skipping stale ones
                    (bounds validation staleness; skipped steps are recorded).
  * STRIDE(k)     — validate every k-th checkpoint.
  * BUDGET        — :class:`BudgetPolicy`: adapt the stride automatically
                    from observed validation latency vs checkpoint cadence
                    (queue depth), bounding staleness without hand-tuning.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Set

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.obs.metrics import MetricsRegistry

#: shared-registry instrument names (see repro_torch.obs): the validator
#: feeds the latency EMA, the watcher feeds the cadence EMA, BudgetPolicy
#: reads both — one source of timing truth instead of private policy state.
VALIDATION_LATENCY_METRIC = "validate.latency_s"
CHECKPOINT_CADENCE_METRIC = "watcher.checkpoint_cadence_s"
DISCOVERY_LAG_METRIC = "watcher.discovery_lag_s"


@dataclasses.dataclass
class Policy:
    kind: str = "fifo"            # fifo | latest_first | stride
    stride: int = 1

    def select(self, pending: List[int]) -> List[int]:
        """Order/filter newly discovered steps for validation."""
        if not pending:
            return []
        if self.kind == "fifo":
            return sorted(pending)
        if self.kind == "latest_first":
            return [max(pending)]
        if self.kind == "stride":
            stride = max(self.stride, 1)
            return sorted(s for s in pending if s % stride == 0)
        raise ValueError(self.kind)

    # feedback hooks (no-ops here; BudgetPolicy adapts on them) -------------
    def observe_latency(self, seconds: float) -> None:
        """Called by the validator after each completed validation."""

    def observe_cadence(self, seconds: float) -> None:
        """Called by the watcher with the inter-arrival time of checkpoints."""


@dataclasses.dataclass
class BudgetPolicy(Policy):
    """Self-tuning stride: keep validation throughput within budget.

    Two coupled signals:
      * queue depth — more pending steps per poll than ``target_depth``
        means validation is falling behind the checkpoint cadence: double
        the stride (halve it again once the queue drains).  This is the
        integrated latency-vs-cadence signal and needs no clocks.
      * latency/cadence ratio — when both have been observed (EMA-smoothed),
        their ratio lower-bounds the stride directly: validating every
        checkpoint is only sustainable when latency <= cadence.

    Selection takes every ``stride``-th pending step counted **from the
    newest**, so the newest checkpoint is always validated — staleness stays
    bounded by one validation, whatever the stride.

    The latency/cadence estimates live as named
    :class:`~repro_torch.obs.metrics.Ewma` instruments in a metrics registry
    rather than private floats: ``observe_latency``/``observe_cadence``
    remain the feed API (same EMA update, bit for bit), but
    :meth:`bind_metrics` can re-home both onto a shared
    :class:`~repro_torch.obs.MetricsRegistry` so the policy reads the same
    ``validate.latency_s`` / ``watcher.checkpoint_cadence_s`` estimates
    that ``--obs_report`` prints — one source of timing truth.
    """

    kind: str = "budget"
    target_depth: int = 1         # pending steps tolerated before widening
    min_stride: int = 1
    max_stride: int = 64
    smooth: float = 0.5           # EMA factor for latency/cadence estimates

    def __post_init__(self):
        self._stride_f = float(max(self.min_stride, 1))
        # private registry until bind_metrics() re-homes the instruments
        self.bind_metrics(MetricsRegistry())

    def bind_metrics(self, registry: MetricsRegistry) -> None:
        """Back the latency/cadence EMAs with ``registry``'s instruments,
        carrying any current estimate over so rebinding mid-run never
        forgets what the policy has learned."""
        lat = registry.ewma(VALIDATION_LATENCY_METRIC, smooth=self.smooth)
        cad = registry.ewma(CHECKPOINT_CADENCE_METRIC, smooth=self.smooth)
        # the policy owns these instruments' smoothing, even when rebinding
        # onto a registry where another party created them first
        lat.smooth = cad.smooth = self.smooth
        prev_lat = getattr(self, "_latency", None)
        prev_cad = getattr(self, "_cadence", None)
        if prev_lat is not None and prev_lat.value is not None \
                and lat.value is None:
            lat.value, lat.count = prev_lat.value, prev_lat.count
        if prev_cad is not None and prev_cad.value is not None \
                and cad.value is None:
            cad.value, cad.count = prev_cad.value, prev_cad.count
        self._latency = lat
        self._cadence = cad

    def observe_latency(self, seconds: float) -> None:
        self._latency.update(seconds)

    def observe_cadence(self, seconds: float) -> None:
        self._cadence.update(seconds)

    @property
    def effective_stride(self) -> int:
        return max(1, int(round(self._stride_f)))

    def select(self, pending: List[int]) -> List[int]:
        if not pending:
            return []
        depth = len(pending)
        if depth > self.target_depth:
            self._stride_f = min(float(self.max_stride), self._stride_f * 2.0)
        elif depth <= self.target_depth:
            self._stride_f = max(float(self.min_stride), self._stride_f / 2.0)
        latency, cadence = self._latency.value, self._cadence.value
        if latency is not None and cadence is not None and cadence > 0:
            floor = min(float(self.max_stride), latency / cadence)
            self._stride_f = max(self._stride_f, floor)
        k = self.effective_stride
        newest_first = sorted(pending, reverse=True)
        return sorted(newest_first[::k])


class CheckpointWatcher:
    def __init__(self, root: str, *, policy: Optional[Policy] = None,
                 skip_existing: bool = False, telemetry=None):
        self.root = root
        self.policy = policy or Policy()
        # telemetry observes discovery (spans + discovery-lag histogram);
        # it never influences which steps poll() returns.  Budget policies
        # re-home their EMAs onto the shared registry here so the same
        # numbers drive scheduling and --obs_report.
        self.telemetry = telemetry
        if telemetry is not None and hasattr(self.policy, "bind_metrics"):
            self.policy.bind_metrics(telemetry.metrics)
        self._seen: Set[int] = set()
        # steps a policy deliberately passed over (stale under latest_first,
        # off-stride, over-budget): they will never be validated, carry no
        # pending quality claim, and so must NOT hold GC protection forever
        # (validator.protect_set subtracts them).  Distinct from handed-out
        # steps that failed — those stay protected.
        self._skipped: Set[int] = set()
        self._last_arrival_t: Optional[float] = None
        # dir names already observed committed: commitment is monotonic (a
        # COMMIT marker never disappears while the dir exists), so each poll
        # only stats entries NOT yet known committed — O(new) stat calls per
        # tick instead of O(all checkpoints), which matters once a long run
        # has accumulated thousands of step dirs.
        self._committed_names: Set[str] = set()
        if skip_existing:
            self._seen.update(self._list_committed())

    def _list_committed(self) -> List[int]:
        """Committed steps, ascending — ``ckpt.list_steps`` semantics with
        the known-committed cache (see ``_committed_names``) so repeated
        polling of a large root stays cheap."""
        if not os.path.isdir(self.root):
            return []
        names = os.listdir(self.root)
        # GC'd checkpoints drop out of the cache with their dirs, so a step
        # re-using a name later (restart from an earlier step) is re-statted
        self._committed_names &= set(names)
        steps = []
        for name in names:
            if not name.startswith(ckpt.STEP_PREFIX) \
                    or name.endswith(".tmp"):
                continue
            try:
                step = int(name[len(ckpt.STEP_PREFIX):])
            except ValueError:
                continue
            if name in self._committed_names \
                    or ckpt.is_committed(os.path.join(self.root, name)):
                self._committed_names.add(name)
                steps.append(step)
        return sorted(steps)

    def poll(self) -> List[int]:
        """New committed steps since the last poll, policy-ordered."""
        steps = [s for s in self._list_committed() if s not in self._seen]
        if steps:
            now = time.monotonic()
            if self._last_arrival_t is not None:
                # inter-arrival estimate for adaptive (budget) policies:
                # time since the previous discovery, amortized per new step
                self.policy.observe_cadence(
                    (now - self._last_arrival_t) / len(steps))
            self._last_arrival_t = now
            tel = self.telemetry
            if tel is not None:
                self._observe_discovery(tel, steps)
        chosen = self.policy.select(steps)
        # every discovered step is consumed by this poll: chosen ones are
        # handed out, the rest are policy-skipped (stale under latest_first,
        # off-stride, over-budget).  Marking BOTH seen keeps the pending
        # list from regrowing — and being re-filtered — on every poll.
        self._seen.update(steps)
        self._skipped.update(set(steps) - set(chosen))
        return chosen

    def _observe_discovery(self, tel, steps: List[int]) -> None:
        """Emit one ``discovered`` event per new step, measure discovery
        lag (COMMIT-marker mtime → now, wall clock — metrics only, never a
        decision input), and mark discovery for the checkpoint-to-verdict
        latency measured when the verdict is recorded."""
        lag_hist = tel.metrics.histogram(DISCOVERY_LAG_METRIC)
        for step in steps:
            lag = None
            marker = os.path.join(ckpt._step_dir(self.root, step),
                                  ckpt.COMMIT_MARKER)
            try:
                lag = max(0.0, time.time() - os.path.getmtime(marker))
            except OSError:
                pass
            if lag is not None:
                lag_hist.observe(lag)
            tel.mark("discovered", step)
            tel.event("discovered", step=step, lag_s=lag)

    @property
    def skipped(self) -> Set[int]:
        """Steps the policy chose never to validate (snapshot)."""
        return set(self._skipped)

    def mark_seen(self, step: int) -> None:
        """Claim ``step`` as handled outside poll() (given-up failures, the
        validator's explicit validate_step): it is consumed, and it is not
        a policy skip — so it keeps (or regains) GC protection until a
        verdict lands."""
        self._seen.add(step)
        self._skipped.discard(step)

    def requeue(self, step: int) -> None:
        """Make ``step`` visible to the next :meth:`poll` again.

        ``poll`` marks a step seen the moment it is *handed out*, before the
        caller knows whether validation succeeded — a checkpoint that fails
        (torn filesystem read, transient OOM) would otherwise be permanently
        swallowed.  The validator calls this on failure so the step is
        retried on a later poll.  The retried step goes back through the
        policy: under ``latest_first``/``budget`` a newer checkpoint may win
        and the failed one is then dropped as stale — that is the staleness
        bound working as intended, not a lost retry."""
        self._seen.discard(step)
        self._skipped.discard(step)
