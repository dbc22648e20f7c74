"""SnapshotChannel — the bounded hand-off ring between trainer and validator
(``repro/handoff/channel.py``).

The trainer publishes a :class:`~repro_torch.handoff.snapshot.ParamSnapshot`
the moment the host copy lands (from the async saver's background thread,
see ``ckpt.AsyncSaver``); the validator claims pending snapshots and scores
them while the durable ``ckpt.save`` is still racing.  Three invariants:

  * **training never blocks** — :meth:`publish` applies drop-oldest-
    unvalidated backpressure: when the ring is full the oldest unclaimed
    snapshot is evicted (its step will be scored later from the durable
    checkpoint via the watcher fallback), and publish returns immediately;
  * **the watcher stays the dedupe authority** — the channel never records
    verdicts; the validator's ledger idempotency plus
    ``watcher.mark_seen`` consume the eventual watcher discovery of a
    snapshot-scored step, so a step arriving via both routes is validated
    exactly once;
  * **durability is tracked, not assumed** — :meth:`mark_durable` /
    :meth:`mark_failed` (wired to the async saver's completion hooks)
    drive :meth:`durability`, which the control plane gates irreversible
    actions (quality GC) on.  Selection and early stopping may act on
    snapshot-scored rows; nothing may delete on the evidence of a step
    that could still fail to persist.

A snapshot of a trainer on a card holds the saver's pinned host buffers
until the ring lets go of it (retired once validated and durable, dropped,
discarded or failed); :meth:`nbytes` reads what the ring holds.  With a
:class:`~repro_torch.handoff.spool.SnapshotSpool` attached, every
publish / eviction is mirrored to the spill directory so validators in
other processes see the same ring.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, List, Optional

from repro_torch.handoff.snapshot import ParamSnapshot

#: durability states a published step moves through
PENDING, DURABLE, FAILED = "pending", "durable", "failed"


class SnapshotChannel:
    """Bounded ring of committed host-resident param snapshots."""

    def __init__(self, capacity: int = 2, *, spool: Any = None,
                 telemetry=None):
        self.capacity = max(1, int(capacity))
        self.spool = spool
        # observation only: a `snapshotted` lifecycle event/mark per publish
        # — the first edge of the snapshot path's ckpt-to-verdict latency.
        self.telemetry = telemetry
        self._lock = threading.Lock()
        self._ring: "OrderedDict[int, ParamSnapshot]" = OrderedDict()
        self._claimed: set = set()          # handed to a validator, in flight
        self._validated: set = set()
        self._state: dict = {}              # step -> PENDING|DURABLE|FAILED
        self._subscribers: List[Callable[[int], None]] = []
        self.dropped: List[int] = []        # backpressure evictions, in order

    # -- trainer side --------------------------------------------------------
    def subscribe(self, fn: Callable[[int], None]) -> None:
        """Register a publish listener (the validator's wake event): called
        with the step after every publish, on the publisher's thread — it
        must be cheap and non-blocking (an ``Event.set`` is the intended
        use)."""
        self._subscribers.append(fn)

    def publish(self, snapshot: ParamSnapshot) -> None:
        """Insert a snapshot; never blocks.  Over capacity, the oldest
        unclaimed-unvalidated snapshot is dropped — the watcher fallback
        owns its verdict from the durable checkpoint later."""
        evicted: List[int] = []
        with self._lock:
            self._ring[snapshot.step] = snapshot
            self._ring.move_to_end(snapshot.step)
            self._state.setdefault(snapshot.step, PENDING)
            while len(self._ring) > self.capacity:
                victim = next(
                    (s for s in self._ring
                     if s not in self._claimed and s != snapshot.step),
                    None)
                if victim is None:
                    # everything older is mid-validation; claimants hold
                    # their own references, so evicting the ring entry is
                    # safe and publish still never blocks
                    victim = next(iter(self._ring))
                self._ring.pop(victim)
                self._claimed.discard(victim)
                if victim not in self._validated:
                    self.dropped.append(victim)
                evicted.append(victim)
        if self.spool is not None:
            self.spool.publish(snapshot.step, snapshot.leaves,
                               snapshot.treedef_hex, extra=snapshot.extra,
                               dtypes=snapshot.dtypes)
            for step in evicted:
                self.spool.retire(step)
        tel = self.telemetry
        if tel is not None:
            tel.mark("snapshotted", snapshot.step)
            tel.event("snapshotted", step=snapshot.step,
                      nbytes=snapshot.nbytes, evicted=evicted or None)
        for fn in self._subscribers:
            fn(snapshot.step)

    def mark_durable(self, step: int) -> None:
        """The durable ``ckpt.save`` committed (async saver hook): the gate
        on irreversible actions opens, and a validated snapshot's host/spool
        copy is reclaimable."""
        with self._lock:
            self._state[step] = DURABLE
        self._maybe_retire(step)

    def mark_failed(self, step: int, error: Any = None) -> None:
        """The durable save failed: the snapshot is evicted (nothing may
        keep acting on evidence of a step that will never persist) and the
        step reports ``failed`` so deferred actions un-block instead of
        waiting forever."""
        with self._lock:
            self._state[step] = FAILED
            self._ring.pop(step, None)
            self._claimed.discard(step)
        if self.spool is not None:
            self.spool.retire(step)

    # -- validator side ------------------------------------------------------
    def pending(self) -> List[int]:
        """Unclaimed, unvalidated snapshot steps in publish order."""
        with self._lock:
            return [s for s in self._ring
                    if s not in self._claimed and s not in self._validated]

    def claim(self, step: int) -> Optional[ParamSnapshot]:
        """Take ``step``'s snapshot for validation (in-process ring first,
        then the spool for cross-process claimants)."""
        with self._lock:
            snap = self._ring.get(step)
            if snap is not None:
                self._claimed.add(step)
                return snap
        if self.spool is not None:
            return self.spool.get(step)
        return None

    def get(self, step: int) -> Optional[ParamSnapshot]:
        """Read-only lookup (the worker's params-view source): no claim
        bookkeeping, so retries and soup re-scores stay side-effect free."""
        with self._lock:
            snap = self._ring.get(step)
        if snap is not None:
            return snap
        if self.spool is not None:
            return self.spool.get(step)
        return None

    def mark_validated(self, step: int) -> None:
        """A verdict landed for ``step`` from the snapshot path."""
        with self._lock:
            self._validated.add(step)
            self._claimed.discard(step)
        self._maybe_retire(step)

    def discard(self, step: int) -> None:
        """Validator-side failure: drop the snapshot so the retry (via the
        watcher, once durable) restores from disk instead of re-reading a
        possibly-poisoned host copy.  Durability state is untouched."""
        with self._lock:
            self._ring.pop(step, None)
            self._claimed.discard(step)
        if self.spool is not None:
            self.spool.retire(step)

    # -- durability gate (control plane) -------------------------------------
    def durability(self, step: int) -> str:
        """``"pending" | "durable" | "failed"`` — steps this channel never
        published report ``durable`` (they were restored from a committed
        checkpoint by construction)."""
        with self._lock:
            return self._state.get(step, DURABLE)

    def is_durable(self, step: int) -> bool:
        return self.durability(step) == DURABLE

    def nbytes(self) -> int:
        """Bytes of the snapshots the ring holds now."""
        with self._lock:
            return sum(s.nbytes for s in self._ring.values())

    # -- internal ------------------------------------------------------------
    def _maybe_retire(self, step: int) -> None:
        """Once a step is BOTH validated and durable its snapshot has no
        remaining consumer: free the host copy and the spool entry."""
        with self._lock:
            done = step in self._validated \
                and self._state.get(step) == DURABLE \
                and step not in self._claimed
            if done:
                self._ring.pop(step, None)
        if done and self.spool is not None:
            self.spool.retire(step)
