"""Checkpoint watcher — the paper's "listen to --ckpts_dir" loop.

Only directories carrying the COMMIT marker are visible (two-phase commit,
see :mod:`repro_torch.ckpt.checkpoint`), so a validator polling while the
trainer is mid-write never reads a torn checkpoint.

Scheduling policies: FIFO (validate every checkpoint in order),
LATEST_FIRST (jump to the newest, skipping stale ones) and STRIDE(k).  The
self-tuning budget policy waits for the slice that ports telemetry.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Set

from repro_torch.ckpt import checkpoint as ckpt


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

    def observe_latency(self, seconds: float) -> None:
        """Called by the validator after each completed validation."""


class CheckpointWatcher:
    def __init__(self, root: str, *, policy: Optional[Policy] = None,
                 skip_existing: bool = False):
        self.root = root
        self.policy = policy or Policy()
        self._seen: Set[int] = set()
        # steps the policy passed over: never validated, so never protected
        self._skipped: Set[int] = set()
        # names already known committed (a COMMIT marker never disappears
        # while its dir exists), so a poll stats only new entries
        self._committed_names: Set[str] = set()
        if skip_existing:
            self._seen.update(self._list_committed())

    def _list_committed(self) -> List[int]:
        if not os.path.isdir(self.root):
            return []
        names = os.listdir(self.root)
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
        """New committed steps since the last poll, policy-ordered; every
        discovered step is consumed (handed out or policy-skipped)."""
        steps = [s for s in self._list_committed() if s not in self._seen]
        chosen = self.policy.select(steps)
        self._seen.update(steps)
        self._skipped.update(set(steps) - set(chosen))
        return chosen

    @property
    def skipped(self) -> Set[int]:
        """Steps the policy chose never to validate (snapshot)."""
        return set(self._skipped)

    def mark_seen(self, step: int) -> None:
        """Claim ``step`` as handled outside poll(); not a policy skip."""
        self._seen.add(step)
        self._skipped.discard(step)

    def requeue(self, step: int) -> None:
        """Make ``step`` visible to the next :meth:`poll` again (a failed
        validation is retried instead of being swallowed)."""
        self._seen.discard(step)
        self._skipped.discard(step)
