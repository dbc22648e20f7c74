"""Control-plane event ledger: every controller decision as a JSONL row
(``repro/control/events.py``).

The validation ledger records *what happened* (metrics per checkpoint); this
log records *what the control plane decided about it* (rankings, stop
verdicts, retention sets, ensemble builds).  Two properties matter:

  * durability: each event is flushed and fsync'd on append, as the
    checkpoint layer commits, so a crashed controller can be audited from
    disk;
  * determinism: events carry no wall-clock state.  Decisions are a pure
    function of the validation rows observed (in observation order), so
    replaying a ledger offline reproduces the identical decision sequence,
    and each event's JSON is byte for byte the JAX package's.

Events split into two classes:

  * decisions (``select``, ``stop``): pure outputs of the controllers;
    byte-identical under offline replay;
  * actuations (``gc``, ``ensemble``, ``stop_marker``, and the serving
    tier's ``swap`` / ``swap_failed``): side effects on the filesystem or a
    live index, recorded for audit but left out of replay comparison.

Payload values must be plain Python values (``None``, ``bool``, ``int``,
``float``, ``str`` and lists, tuples and dicts of them): a tensor or a
numpy integer would break ``json`` or the bytes, so :meth:`ControlEventLog.
emit` raises ``TypeError`` on one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Iterator, List, Optional

from repro_torch.core.jsonl import read_jsonl_tolerant, truncate_torn_tail

DECISION_KINDS = frozenset({"select", "stop"})
ACTUATION_KINDS = frozenset({"gc", "ensemble", "stop_marker",
                             # serving tier: live index hot-swaps and
                             # aborted promotions
                             "swap", "swap_failed"})


def _check_plain(key: str, value) -> None:
    if value is None or isinstance(value, (bool, int, float, str)):
        return
    if isinstance(value, (list, tuple)):
        for item in value:
            _check_plain(key, item)
        return
    if isinstance(value, dict):
        for k, item in value.items():
            if not isinstance(k, str):
                raise TypeError(f"control event payload {key!r}: dict key "
                                f"{k!r} is not a str")
            _check_plain(key, item)
        return
    raise TypeError(f"control event payload {key!r}: {type(value).__name__} "
                    "is not a plain Python value")


@dataclasses.dataclass(frozen=True)
class ControlEvent:
    seq: int
    kind: str
    step: int
    payload: dict

    def to_json(self) -> str:
        return json.dumps({"seq": self.seq, "kind": self.kind,
                           "step": self.step, **self.payload},
                          sort_keys=True)


class ControlEventLog:
    """Append-only, fsync'd, restart-loading event log (thread-safe)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._events: List[ControlEvent] = []
        self._lock = threading.Lock()
        self._torn_offset = None
        if path and os.path.exists(path):
            # a torn FINAL line (emit died mid-write) is dropped on load and
            # truncated by this writer just before its next emit; loading
            # never mutates the file, and interior corruption raises
            recs, self._torn_offset = read_jsonl_tolerant(
                path, kind="control event")
            for rec in recs:
                seq, kind, step = (rec.pop("seq"), rec.pop("kind"),
                                   rec.pop("step"))
                self._events.append(ControlEvent(
                    seq=int(seq), kind=kind, step=int(step), payload=rec))

    def emit(self, kind: str, step: int, **payload) -> ControlEvent:
        for key, value in payload.items():
            _check_plain(key, value)
        with self._lock:
            ev = ControlEvent(seq=len(self._events), kind=kind,
                              step=int(step), payload=payload)
            self._events.append(ev)
            if self.path:
                if self._torn_offset is not None:   # writer-side repair
                    truncate_torn_tail(self.path, self._torn_offset)
                    self._torn_offset = None
                with open(self.path, "a") as f:
                    f.write(ev.to_json() + "\n")
                    f.flush()
                    os.fsync(f.fileno())
            return ev

    def events(self) -> List[ControlEvent]:
        with self._lock:
            return list(self._events)

    def decisions(self) -> List[ControlEvent]:
        """Replay-comparable subset: pure decisions, renumbered densely so
        interleaved actuations (absent offline) do not shift the seq ids."""
        out = []
        for ev in self.events():
            if ev.kind in DECISION_KINDS:
                out.append(dataclasses.replace(ev, seq=len(out)))
        return out

    def __iter__(self) -> Iterator[ControlEvent]:
        return iter(self.events())

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)
