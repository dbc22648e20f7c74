"""Convergence control plane: the feedback half of Asyncval
(``repro/control``).

Consumes the validation ledger that the async validator produces and closes
the loop: checkpoint selection and quality-aware retention (``selection``),
asynchronous early stopping through an atomic STOP marker (``earlystop``),
checkpoint-ensemble virtual checkpoints (``ensemble``), with every decision
recorded as a replayable JSONL event (``events``), byte for byte the JAX
package's.  ``plane.ControlPlane`` bundles them behind the
``AsyncValidator(controller=...)`` hook.
"""

from repro_torch.control.earlystop import (EarlyStopConfig,
                                           EarlyStopController,
                                           stop_requested, write_stop_marker)
from repro_torch.control.ensemble import (average_params, greedy_soup,
                                          materialize_virtual, uniform_soup)
from repro_torch.control.events import (ACTUATION_KINDS, DECISION_KINDS,
                                        ControlEvent, ControlEventLog)
from repro_torch.control.metricspec import (MetricSpec, flatten_rows,
                                            metric_mode)
from repro_torch.control.plane import (ControlConfig, ControlPlane,
                                       replay_ledger)
from repro_torch.control.selection import (CheckpointSelector,
                                           SelectionConfig)

__all__ = [
    "ACTUATION_KINDS", "DECISION_KINDS", "ControlEvent", "ControlEventLog",
    "CheckpointSelector", "SelectionConfig",
    "EarlyStopConfig", "EarlyStopController", "stop_requested",
    "write_stop_marker",
    "average_params", "greedy_soup", "materialize_virtual", "uniform_soup",
    "ControlConfig", "ControlPlane", "replay_ledger",
    "MetricSpec", "flatten_rows", "metric_mode",
]
