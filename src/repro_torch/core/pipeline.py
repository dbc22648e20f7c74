"""ValidationPipeline — DEPRECATED single-task shim over the ValidationSuite
(``repro/core/pipeline.py``).

The public validation API lives in :mod:`repro_torch.core.suite`: a
:class:`~repro_torch.core.suite.ValidationSuite` validates checkpoints
against N :class:`~repro_torch.core.suite.ValidationTask`\\ s in one pass.
This module keeps the one-corpus / one-queries / one-qrels constructor: a
``ValidationPipeline`` is a one-task suite whose task is named
``"default"``, and ``validate_params`` returns that task's
:class:`~repro_torch.core.suite.ValidationResult` unchanged.

``ValidationConfig`` / ``ValidationResult`` / ``params_from_checkpoint``
are re-exported here.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

from repro_torch.core.suite import (SuiteResult, ValidationConfig,
                                    ValidationResult, ValidationSuite,
                                    ValidationTask, params_from_checkpoint)

__all__ = ["ValidationConfig", "ValidationResult", "ValidationPipeline",
           "params_from_checkpoint"]

_DEPRECATION_MSG = (
    "ValidationPipeline is deprecated; build a ValidationSuite with a "
    "single ValidationTask instead (repro_torch.core.suite).")
_warned = False


class ValidationPipeline:
    """Deprecated façade: one validation task, suite underneath.

    Emits a :class:`DeprecationWarning` exactly once per process (the shim
    is a migration aid, not a nag).  All documented legacy attributes —
    ``engine``, ``subset``, ``doc_ids``, ``doc_texts``, ``query_ids``,
    ``query_texts``, ``sampler_name`` — keep working.
    """

    def __init__(self, spec, corpus: Dict[str, list],
                 queries: Dict[str, list], qrels: Dict[str, Dict[str, int]],
                 vcfg: ValidationConfig, *, sampler=None,
                 baseline_run: Optional[Dict[str, list]] = None,
                 engine=None):
        global _warned
        if not _warned:
            _warned = True
            warnings.warn(_DEPRECATION_MSG, DeprecationWarning, stacklevel=2)
        task = ValidationTask("default", corpus, queries, qrels,
                              mode=vcfg.mode, sampler=sampler,
                              baseline_run=baseline_run,
                              metrics=tuple(vcfg.metrics), k=vcfg.k)
        self.suite = ValidationSuite(spec, [task], vcfg)
        self.spec = spec
        self.vcfg = vcfg
        self.qrels = qrels
        self._engine_override = engine
        data = self.suite._data["default"]
        self.query_ids = data.query_ids
        self.query_texts = data.query_texts
        self.sampler_name = self.suite.sampler_names["default"]
        self.subset = self.suite.subsets["default"]
        self.doc_ids = data.doc_ids
        self.doc_texts = data.doc_texts
        if engine is None:
            # legacy behaviour: the engine (and every config error it can
            # raise — bad staging, mmap without a dir) surfaces at
            # construction time, not at the first validate_params
            self.suite.engine("default")

    # validator-facing surface (same duck type as ValidationSuite) ----------
    task_names = ("default",)

    @property
    def engine(self):
        return self._engine_override if self._engine_override is not None \
            else self.suite.engine("default")

    # -- one checkpoint ----------------------------------------------------
    def validate_params(self, params, step: int = 0, *,
                        engine=None) -> ValidationResult:
        """Validate one checkpoint.  ``engine`` overrides the pipeline's
        engine for this call only (the AsyncValidator injection path) —
        the pipeline itself is never mutated."""
        eng = engine if engine is not None else self._engine_override
        res: SuiteResult = self.suite.validate_params(params, step=step,
                                                      engine=eng)
        return res.tasks["default"]
