"""The claimable unit of validation work: one checkpoint x one task.

Only :class:`WorkUnit` is ported so far — the suite plans its work as these
units and runs them in-line.  The fleet's ledger-backed work queue waits for
the slice that ports the validator fleet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class WorkUnit:
    """One claimable piece of validation work: one checkpoint x one task.

    ``requires`` maps capability names to minima a worker must meet
    (numeric: worker value >= requirement; otherwise: equality)."""

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
