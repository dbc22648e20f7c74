"""Claimable (step, task) work units over the validation ledger: the
coordination layer of the validator fleet (``repro/core/workqueue.py``).

The schema-v2 ledger keys one fsync'd row per ``(step, task)``, which is
the shape of a distributed work queue, so the queue IS the ledger:
claim / renew / complete / abandon records are appended to the same JSONL
file as sibling record types, and every fleet decision (who owns which
unit, which lease expired, which unit is retried) is a pure function of the
record sequence.  A crash loses work units, never correctness, and
:func:`replay` re-derives the same decision sequence offline.

Claim-record schema (sibling records of the v2 ledger; result rows carry no
``"kind"`` key and every row loader skips kind-bearing records):

    {"kind": "unit",     "step": S, "task": T, "requires": {...}}
    {"kind": "claim",    "step": S, "task": T, "worker": W}
    {"kind": "renew",    "step": S, "task": T, "worker": W}
    {"kind": "complete", "step": S, "task": T, "worker": W}
    {"kind": "abandon",  "step": S, "task": T, "worker": W, "error": "..."}
    {"kind": "tick",     "worker": W}

The records are the reference package's, key for key and in the same key
order, written through the same atomic append, so a ledger written by
either package folds and replays the same through the other.

  * ``unit`` publishes a discovered checkpoint as one unit per suite task;
    ``requires`` names capability minima (``{"mesh_size": 8}``).
  * ``claim`` is a bid.  It wins iff, at its position in the record
    sequence, the unit is open or its lease has expired; a bid against a
    live lease loses and every reader ignores it.  Appends are atomic
    (one ``O_APPEND`` write), so the order is total and every worker
    derives the same winner.
  * ``renew`` is the holder's lease heartbeat.
  * ``complete`` follows the unit's result rows, so a complete always has
    its result.
  * ``abandon`` releases a unit whose validation failed; the per-unit
    abandon count is the fleet's retry budget, derived from the ledger.
  * ``tick`` is a sequence-only heartbeat that a worker blocked behind
    other workers' live leases appends, so a dead peer's lease can expire.

Leases are measured in ledger sequence, not wall clock: a lease expires
once more than ``lease_ttl`` records follow its claim or latest renew.  No
wall-clock value feeds a decision, so :func:`replay` reproduces the online
fleet's choices exactly, including which worker reclaimed a crashed
peer's unit, and when.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

from repro_torch.core.jsonl import (append_jsonl_atomic,
                                    read_jsonl_tolerant)

QUEUE_KINDS = frozenset({"unit", "claim", "renew", "complete", "abandon",
                         "tick"})

#: unit lifecycle states derived from the record fold
OPEN, CLAIMED, DONE, FAILED = "open", "claimed", "done", "failed"


@dataclasses.dataclass(frozen=True)
class WorkUnit:
    """One claimable piece of validation work: one checkpoint x one task.

    ``requires`` maps capability names to minima a worker must meet
    (numeric: worker value >= requirement; otherwise: equality) — e.g.
    ``{"mesh_size": 8}`` keeps a full-corpus sharded task away from a CPU
    smoke worker."""

    step: int
    task: str = "default"
    requires: Tuple[Tuple[str, Any], ...] = ()

    @classmethod
    def make(cls, step: int, task: str = "default",
             requires: Optional[Mapping[str, Any]] = None) -> "WorkUnit":
        return cls(step=int(step), task=str(task),
                   requires=tuple(sorted((requires or {}).items())))

    @property
    def key(self) -> Tuple[int, str]:
        return (self.step, self.task)

    @property
    def requires_dict(self) -> Dict[str, Any]:
        return dict(self.requires)


def meets(capabilities: Mapping[str, Any],
          requires: Mapping[str, Any]) -> bool:
    """True when a worker's capability tags satisfy a unit's requirements:
    numeric requirements are minima, everything else must match exactly; a
    capability the worker does not declare fails the unit."""
    for key, need in (requires or {}).items():
        have = (capabilities or {}).get(key)
        if have is None:
            return False
        if isinstance(need, (int, float)) and isinstance(have, (int, float)):
            if have < need:
                return False
        elif have != need:
            return False
    return True


@dataclasses.dataclass
class UnitState:
    """Fold state of one (step, task) unit."""

    unit: WorkUnit
    status: str = OPEN
    holder: Optional[str] = None        # claiming worker while CLAIMED
    touch_seq: int = -1                 # seq of the claim/latest renew
    claim_seq: int = -1                 # seq of the winning claim
    abandons: int = 0                   # distributed retry counter
    completed_by: Optional[str] = None
    source: str = ""                    # publish route ("snapshot" | "")

    def lease_live(self, head_seq: int, ttl: int) -> bool:
        return self.status == CLAIMED and head_seq - self.touch_seq <= ttl


class QueueState:
    """Deterministic fold of the ledger's record sequence into fleet state.

    Every reader (worker claim loops, the supervisor's control pump,
    offline :func:`replay`) folds the SAME records with the SAME rules, so
    all of them agree on unit ownership without any channel beyond the
    ledger file.  ``events`` is the decision trace (claims won/lost/
    reclaimed, completions, expiry-reclaims) for offline audit."""

    def __init__(self, lease_ttl: int = 16, max_abandons: int = 2):
        self.lease_ttl = int(lease_ttl)
        self.max_abandons = int(max_abandons)
        self.units: Dict[Tuple[int, str], UnitState] = {}
        self.result_rows: List[dict] = []   # schema-v2 rows, seq order
        self.events: List[dict] = []        # fleet decision trace
        self.head_seq = -1                  # seq of the last folded record

    # -- folding -------------------------------------------------------------
    def fold(self, rec: dict) -> None:
        self.head_seq += 1
        seq = self.head_seq
        kind = rec.get("kind")
        if kind is None:                    # schema-v2 result row
            self.result_rows.append(rec)
            key = (int(rec["step"]), str(rec.get("task", "default")))
            st = self.units.get(key)
            if st is not None and st.status != DONE:
                st.status = DONE
                st.completed_by = rec.get("worker_id") or st.holder
            return
        if kind == "tick":                  # seq progress only
            return
        key = (int(rec["step"]), str(rec.get("task", "default")))
        worker = str(rec.get("worker", ""))
        st = self.units.get(key)
        if kind == "unit":
            if st is None:
                unit = WorkUnit.make(key[0], key[1],
                                     rec.get("requires") or {})
                self.units[key] = UnitState(
                    unit=unit, source=str(rec.get("source", "")))
                self.events.append({"seq": seq, "event": "publish",
                                    "step": key[0], "task": key[1]})
            return                          # re-publish: no-op
        if st is None:
            # claim/renew/... for a unit never published: tolerate by
            # materializing it (a worker may enqueue ad-hoc units, e.g.
            # soup-candidate scoring fanned out without a supervisor)
            st = self.units[key] = UnitState(unit=WorkUnit.make(*key))
        if kind == "claim":
            self._fold_claim(st, worker, seq)
        elif kind == "renew":
            if st.status == CLAIMED and st.holder == worker:
                st.touch_seq = seq
        elif kind == "complete":
            if st.status != DONE:
                st.status, st.completed_by = DONE, worker
                self.events.append({"seq": seq, "event": "complete",
                                    "step": key[0], "task": key[1],
                                    "worker": worker})
        elif kind == "abandon":
            if st.status == CLAIMED and st.holder == worker:
                st.abandons += 1
                st.status, st.holder = OPEN, None
                if st.abandons > self.max_abandons:
                    st.status = FAILED      # retry budget exhausted
                self.events.append({"seq": seq, "event": "abandon",
                                    "step": key[0], "task": key[1],
                                    "worker": worker,
                                    "abandons": st.abandons,
                                    "failed": st.status == FAILED})

    def _fold_claim(self, st: UnitState, worker: str, seq: int) -> None:
        key = st.unit.key
        if st.status == DONE or st.status == FAILED:
            return                          # late claim: silently lost
        if st.status == CLAIMED and st.holder == worker:
            st.touch_seq = seq              # self-claim acts as a renew
            return
        if st.status == CLAIMED:
            if seq - st.touch_seq <= self.lease_ttl:
                self.events.append({"seq": seq, "event": "claim_lost",
                                    "step": key[0], "task": key[1],
                                    "worker": worker, "holder": st.holder})
                return                      # live lease: bid loses
            # expired lease: crash-safe reclaim
            self.events.append({"seq": seq, "event": "reclaim",
                                "step": key[0], "task": key[1],
                                "worker": worker, "from": st.holder,
                                "expired_touch": st.touch_seq})
        else:
            self.events.append({"seq": seq, "event": "claim",
                                "step": key[0], "task": key[1],
                                "worker": worker})
        st.status, st.holder = CLAIMED, worker
        st.claim_seq = st.touch_seq = seq

    # -- queries -------------------------------------------------------------
    def get(self, step: int, task: str = "default") -> Optional[UnitState]:
        return self.units.get((int(step), str(task)))

    def holder(self, step: int, task: str = "default") -> Optional[str]:
        st = self.get(step, task)
        return st.holder if st is not None and st.status == CLAIMED else None

    def claimable(self, capabilities: Optional[Mapping[str, Any]] = None
                  ) -> List[WorkUnit]:
        """Units a worker with ``capabilities`` may bid on NOW: open, or
        held under an expired lease — sorted (step, task) so every worker
        walks the backlog in the same order."""
        out = []
        for st in self.units.values():
            if st.status == OPEN or (
                    st.status == CLAIMED
                    and not st.lease_live(self.head_seq, self.lease_ttl)):
                if meets(capabilities or {}, st.unit.requires_dict):
                    out.append(st.unit)
        return sorted(out, key=lambda u: u.key)

    def blocked(self) -> List[WorkUnit]:
        """Units held by live leases of OTHER workers (pending, not ours to
        take yet) — a worker seeing only these appends a tick so a dead
        holder's lease can age out."""
        return sorted((st.unit for st in self.units.values()
                       if st.lease_live(self.head_seq, self.lease_ttl)),
                      key=lambda u: u.key)

    def claimed_steps(self) -> set:
        """Steps with at least one LIVE claim — GC protection for work in
        flight on other workers."""
        return {st.unit.step for st in self.units.values()
                if st.lease_live(self.head_seq, self.lease_ttl)}

    def incomplete_steps(self) -> set:
        return {st.unit.step for st in self.units.values()
                if st.status not in (DONE,)}

    def completed_units(self) -> List[Tuple[int, str]]:
        return sorted(k for k, st in self.units.items() if st.status == DONE)

    def step_complete(self, step: int,
                      expected_tasks: Iterable[str]) -> bool:
        return all((st := self.units.get((int(step), t))) is not None
                   and st.status == DONE for t in expected_tasks)


class WorkQueue:
    """One worker's (or the supervisor's) handle on the shared ledger queue.

    All mutation is append-only through
    :func:`~repro_torch.core.jsonl.append_jsonl_atomic`; all state is derived by
    re-folding the file (incrementally — the file is append-only, so
    :meth:`refresh` reads only the bytes appended since the last call).
    ``worker_id`` names this participant in every record it appends;
    ``capabilities`` are its tags matched against unit requirements."""

    def __init__(self, path: str, worker_id: str = "worker-0", *,
                 capabilities: Optional[Mapping[str, Any]] = None,
                 lease_ttl: int = 16, max_abandons: int = 2,
                 telemetry=None):
        self.path = path
        self.worker_id = str(worker_id)
        self.capabilities = dict(capabilities or {})
        self.lease_ttl = int(lease_ttl)
        self.max_abandons = int(max_abandons)
        self._offset = 0            # first unconsumed byte of the file
        self.state = QueueState(lease_ttl=lease_ttl,
                                max_abandons=max_abandons)
        # telemetry mirrors the fold's decision events into fleet.* counters
        # (publish/claim/claim_lost/reclaim/complete/abandon, as observed by
        # THIS handle's fold) and emits published/claimed lifecycle events.
        # It reads the decision trace; it never feeds it — replay() stays
        # byte-identical with telemetry on or off.
        self.telemetry = telemetry
        self._events_counted = 0    # fold-events watermark for the mirrors
        self._rows_counted = 0      # result-rows watermark (completions)

    # -- reading -------------------------------------------------------------
    def refresh(self) -> QueueState:
        """Fold any newly appended records and return the current state."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return self.state
        rebuilt = False
        if size < self._offset:
            # the file shrank: a restarting appender repaired a torn tail
            # below our read offset — refold from scratch
            self._offset = 0
            self.state = QueueState(lease_ttl=self.lease_ttl,
                                    max_abandons=self.max_abandons)
            rebuilt = True
        if size == self._offset:
            return self.state
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            data = f.read()
        # only complete lines are folded; a trailing fragment (a concurrent
        # append in flight, or a crashed writer's torn tail) is NOT consumed
        # — the offset stays at its start, so the next refresh re-reads it
        # whole (or past its repair)
        lines = data.split(b"\n")
        fragment = lines.pop()
        self._offset += len(data) - len(fragment)
        for ln in lines:
            if not ln.strip():
                continue
            try:
                rec = json.loads(ln)
            except ValueError:
                # an interior unparseable line can only be a crashed
                # writer's fragment that a later appender newline-guarded;
                # every reader skips it identically, so determinism holds
                continue
            self.state.fold(rec)
        tel = self.telemetry
        if tel is not None:
            events = self.state.events
            rows = self.state.result_rows
            if rebuilt:
                # the refold replayed history this handle already mirrored;
                # resync the watermarks instead of double-counting
                self._events_counted = len(events)
                self._rows_counted = len(rows)
            else:
                for ev in events[self._events_counted:]:
                    tel.metrics.counter(f"fleet.{ev['event']}").inc()
                self._events_counted = len(events)
                # in the repo flow the verdict ROW marks a unit DONE (the
                # explicit complete record then folds as a no-op, emitting
                # no event), so rows are the global completion count
                fresh_rows = len(rows) - self._rows_counted
                if fresh_rows:
                    tel.metrics.counter("fleet.complete").inc(fresh_rows)
                self._rows_counted = len(rows)
        return self.state

    # -- appending -----------------------------------------------------------
    def _append(self, recs: List[dict]) -> None:
        append_jsonl_atomic(self.path, recs)

    def publish(self, units: Iterable[WorkUnit], *,
                source: str = "") -> List[WorkUnit]:
        """Publish not-yet-known units (the watcher layer: discovered steps
        become claimable work).  Already-published units are skipped, so
        re-publishing after a supervisor restart is idempotent — a step
        spilled by the hand-off spool (``source="snapshot"``) and later
        discovered durable by the watcher publishes exactly once, keeping
        first-route-wins dedupe in the fold itself.  ``source`` stamps the
        unit record for audit; omitted when empty, so pre-handoff ledgers
        stay byte-identical."""
        self.refresh()
        fresh = [u for u in units if u.key not in self.state.units]
        if fresh:
            recs = []
            for u in fresh:
                rec = {"kind": "unit", "step": u.step, "task": u.task,
                       "requires": u.requires_dict}
                if source:
                    rec["source"] = source
                recs.append(rec)
            self._append(recs)
            self.refresh()
            tel = self.telemetry
            if tel is not None:
                for u in fresh:
                    tel.event("published", step=u.step, task=u.task,
                              **({"source": source} if source else {}))
        return fresh

    def try_claim(self, unit: WorkUnit) -> bool:
        """Bid for ``unit``; True iff OUR claim won (we now hold the lease).
        The winner is decided by the fold over the totally-ordered record
        sequence, never locally — so two workers bidding concurrently agree
        on the outcome by construction."""
        self._append([{"kind": "claim", "step": unit.step, "task": unit.task,
                       "worker": self.worker_id}])
        st = self.refresh().get(unit.step, unit.task)
        won = st is not None and st.status == CLAIMED \
            and st.holder == self.worker_id
        tel = self.telemetry
        if tel is not None and won:
            tel.event("claimed", step=unit.step, task=unit.task)
        return won

    def renew(self, unit: WorkUnit) -> None:
        """Heartbeat: re-stamp our lease so it cannot expire while the
        engine run is still in flight."""
        self._append([{"kind": "renew", "step": unit.step, "task": unit.task,
                       "worker": self.worker_id}])
        tel = self.telemetry
        if tel is not None:
            tel.metrics.counter("fleet.renew").inc()

    def complete(self, unit: WorkUnit) -> None:
        self._append([{"kind": "complete", "step": unit.step,
                       "task": unit.task, "worker": self.worker_id}])
        self.refresh()

    def abandon(self, unit: WorkUnit, error: str = "") -> None:
        self._append([{"kind": "abandon", "step": unit.step,
                       "task": unit.task, "worker": self.worker_id,
                       "error": error}])
        self.refresh()

    def tick(self) -> None:
        """Seq-only heartbeat: appended when this worker is blocked behind
        other workers' live leases, so a DEAD holder's lease ages out (seq
        is the clock — without progress, no lease ever expires)."""
        self._append([{"kind": "tick", "worker": self.worker_id}])

    def claimable(self) -> List[WorkUnit]:
        return self.refresh().claimable(self.capabilities)


def replay(path_or_records, *, lease_ttl: int = 16,
           max_abandons: int = 2) -> QueueState:
    """Offline fleet replay: fold a ledger file (or an iterable of decoded
    records) and return the terminal :class:`QueueState` — ``state.events``
    is the decision trace the online fleet actually made, because online
    workers decide by exactly this fold over exactly these records.
    ``lease_ttl``/``max_abandons`` must match the online fleet's."""
    state = QueueState(lease_ttl=lease_ttl, max_abandons=max_abandons)
    if isinstance(path_or_records, str):
        records, _ = read_jsonl_tolerant(path_or_records, kind="ledger row")
    else:
        records = path_or_records
    for rec in records:
        state.fold(rec)
    return state


def parse_capabilities(spec: Optional[str]) -> Dict[str, Any]:
    """Parse a CLI capability string (``"mesh_size=8,max_depth=100"``) into
    typed tags: ints/floats where they parse, strings otherwise."""
    out: Dict[str, Any] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"capability {part!r} must be name=value")
        k, v = part.split("=", 1)
        k, v = k.strip(), v.strip()
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out
