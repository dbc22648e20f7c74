"""ValidationSuite — the toolkit's public validation API (``repro/core/suite.py``).

A *task* is a (corpus, queries, qrels) triple with its mode, sampler,
metrics and retrieval cut-off; a *suite* validates every checkpoint against
N tasks in one pass.  Each task's sampler runs once (the subset depends on
the baseline run and qrels, never on the checkpoint), tasks over the same
sampled corpus share one padded TokenStore, and each task's engine is built
lazily through :func:`repro_torch.core.engine.make_engine`.  A
:class:`repro_torch.obs.Telemetry` on the config receives one ``scored``
span per (step, task) and a ``store_build`` span per padded store, with the
engines' spans nested under ``scored``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.core import metrics as metrics_lib
from repro_torch.core.engine import (TokenStore, ValidationStore,
                                     chunk_geometry, doc_cache_dir,
                                     make_engine)
from repro_torch.core.registry import ENGINES, MODES, resolve_sampler
from repro_torch.core.samplers import SubsetResult
from repro_torch.core.workqueue import WorkUnit
from repro_torch.models.biencoder import EncoderSpec


@dataclasses.dataclass
class ValidationConfig:
    """How to validate — shared across every task of a suite.  ``metrics`` /
    ``mode`` / ``k`` double as the defaults a :class:`ValidationTask` can
    override per task."""

    metrics: tuple = ("MRR@10",)
    mode: str = "retrieval"          # retrieval | rerank | average_rank
    k: int = 100                     # retrieval cut-off
    batch_size: int = 64
    impl: str = "torch"              # torch | cuda (the topk_mips kernels)
    engine: str = "streaming"        # streaming | materialized
    chunk_size: Optional[int] = None  # streaming chunk rows; None -> batch_size
    staging: str = "double_buffered"  # double_buffered | sync host->device
    staging_depth: int = 2           # batches staged ahead of compute
    token_backing: str = "memory"    # memory | mmap (out-of-core TokenStore)
    mmap_dir: Optional[str] = None   # cache dir for token_backing="mmap"
    token_fingerprint: str = "fast"  # fast (O(1)) | full (content hash)
    rerank_block: Optional[int] = None  # queries per materialized rerank
                                     # candidate gather (None = auto budget)
    score_dtype: str = "f32"         # scoring precision: f32 | bf16 | int8
    rerank_compact: bool = True      # pack sparse rerank candidates into
                                     # dense pseudo-chunks before encoding
    write_run: bool = False
    output_dir: Optional[str] = None
    run_tag: str = "asyncval"
    # nullable repro_torch.obs.Telemetry: lifecycle spans and engine
    # metrics; left out of comparisons, so configs that differ only in
    # instrumentation compare equal
    telemetry: Any = dataclasses.field(default=None, compare=False,
                                       repr=False)


@dataclasses.dataclass
class ValidationResult:
    """One checkpoint x one task."""

    step: int
    metrics: Dict[str, float]
    timings: Dict[str, float]
    subset_size: int
    engine: str = ""
    score_dtype: str = "f32"
    task: str = "default"
    # "snapshot" when scored from a pre-durable hand-off snapshot, "" when
    # restored from the durable checkpoint; ledgered only when "snapshot"
    handoff: str = ""


@dataclasses.dataclass
class ValidationTask:
    """One validation set: the data triple plus how to score it.  ``mode`` /
    ``metrics`` / ``k`` of ``None`` inherit the suite config's values;
    ``sampler`` is a sampler instance or a registered sampler name."""

    name: str
    corpus: Dict[str, list]
    queries: Dict[str, list]
    qrels: Dict[str, Dict[str, int]]
    mode: Optional[str] = None
    sampler: Any = None
    sampler_depth: int = 0
    baseline_run: Optional[Dict[str, list]] = None
    metrics: Optional[tuple] = None
    k: Optional[int] = None
    requires: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError(f"task name must be a non-empty string, "
                             f"got {self.name!r}")
        if ":" in self.name:
            raise ValueError(f"task name {self.name!r} must not contain ':'")


@dataclasses.dataclass
class SuiteResult:
    """One checkpoint x every task, in suite order."""

    step: int
    tasks: Dict[str, ValidationResult]

    @property
    def metrics(self) -> Dict[str, float]:
        """Every metric under ``"task:metric"``, plus bare names for the
        ``"default"`` task."""
        flat: Dict[str, float] = {}
        for name, res in self.tasks.items():
            if name == "default":
                flat.update(res.metrics)
        for name, res in self.tasks.items():
            for m, v in res.metrics.items():
                flat[f"{name}:{m}"] = v
        return flat

    @property
    def log_metrics(self) -> Dict[str, float]:
        """Reporter columns: bare names for the ``default`` task,
        task-qualified names for every other task."""
        flat: Dict[str, float] = {}
        for name, res in self.tasks.items():
            if name == "default":
                flat.update(res.metrics)
            else:
                flat.update({f"{name}:{m}": v
                             for m, v in res.metrics.items()})
        return flat

    @property
    def timings(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for res in self.tasks.values():
            for k, v in res.timings.items():
                out[k] = out.get(k, 0.0) + float(v)
        return out

    @property
    def subset_size(self) -> int:
        return sum(r.subset_size for r in self.tasks.values())

    @property
    def engine(self) -> str:
        names = {r.engine for r in self.tasks.values()}
        return names.pop() if len(names) == 1 else ",".join(sorted(names))

    @property
    def score_dtype(self) -> str:
        names = {r.score_dtype for r in self.tasks.values()}
        return names.pop() if len(names) == 1 else ",".join(sorted(names))

    @property
    def handoff(self) -> str:
        names = {r.handoff or "durable" for r in self.tasks.values()}
        return names.pop() if len(names) == 1 else ",".join(sorted(names))


class ValidationSuite:
    """Validate checkpoints against N tasks in one pass, sharing stores.
    ``engines`` optionally injects a pre-built engine per task name."""

    def __init__(self, spec: EncoderSpec, tasks: Sequence[ValidationTask],
                 vcfg: Optional[ValidationConfig] = None, *,
                 engines: Optional[Dict[str, Any]] = None):
        vcfg = vcfg if vcfg is not None else ValidationConfig()
        self.spec = spec
        self.vcfg = vcfg
        self.tasks: Dict[str, ValidationTask] = {}
        for t in tasks:
            if t.name in self.tasks:
                raise ValueError(f"duplicate task name {t.name!r}")
            t = dataclasses.replace(
                t, mode=t.mode if t.mode is not None else vcfg.mode,
                metrics=tuple(t.metrics) if t.metrics is not None
                else tuple(vcfg.metrics),
                k=t.k if t.k is not None else vcfg.k)
            MODES.get(t.mode)                    # fail fast, with options
            self.tasks[t.name] = t
        if not self.tasks:
            raise ValueError("ValidationSuite needs at least one task")
        self._engines: Dict[str, Any] = dict(engines or {})
        self._stores: Dict[tuple, TokenStore] = {}
        self._store_order: Dict[tuple, int] = {}
        self.store_builds = 0
        self.subsets: Dict[str, SubsetResult] = {}
        self.sampler_names: Dict[str, str] = {}
        self._data: Dict[str, ValidationStore] = {}
        for name, t in self.tasks.items():
            sampler = resolve_sampler(t.sampler, depth=t.sampler_depth)
            self.sampler_names[name] = sampler.name
            subset = sampler.sample(list(t.corpus), t.baseline_run, t.qrels)
            self.subsets[name] = subset
            qids = list(t.queries)
            self._data[name] = ValidationStore(
                query_ids=qids,
                query_texts=[t.queries[q] for q in qids],
                doc_ids=subset.doc_ids,
                doc_texts=[t.corpus[d] for d in subset.doc_ids],
                per_query=subset.per_query)
        if vcfg.token_backing == "mmap":
            # each distinct store gets its cache-dir index now, in task
            # order, so the lazy build order never remaps the directories
            for name, t in self.tasks.items():
                key = self._store_key(t, self._data[name], self._task_cfg(t))
                self._store_order.setdefault(key, len(self._store_order))

    @property
    def task_names(self) -> Tuple[str, ...]:
        return tuple(self.tasks)

    def _task_cfg(self, task: ValidationTask) -> ValidationConfig:
        return dataclasses.replace(self.vcfg, mode=task.mode,
                                   metrics=tuple(task.metrics), k=task.k)

    def _store_key(self, task: ValidationTask, data: ValidationStore,
                   tcfg: ValidationConfig) -> tuple:
        chunk, _ = chunk_geometry(tcfg, len(data.doc_texts))
        ids = hashlib.sha1("\x00".join(data.doc_ids).encode()).hexdigest()
        return (id(task.corpus), ids, chunk, self.spec.p_max_len,
                tcfg.token_backing, tcfg.token_fingerprint)

    def _shared_doc_store(self, task: ValidationTask, data: ValidationStore,
                          tcfg: ValidationConfig) -> TokenStore:
        """Tasks whose sampled corpus, chunk geometry and backing match
        share one padded store (and, for mmap backing, one cache
        directory)."""
        key = self._store_key(task, data, tcfg)
        store = self._stores.get(key)
        if store is None:
            if tcfg.token_backing == "mmap" and not tcfg.mmap_dir:
                raise ValueError("token_backing='mmap' needs mmap_dir")
            index = self._store_order.setdefault(key, len(self._store_order))
            chunk, _ = chunk_geometry(tcfg, len(data.doc_texts))
            tel = self.vcfg.telemetry
            with tel.span("store_build", task=task.name,
                          n_docs=len(data.doc_texts),
                          backing=tcfg.token_backing) \
                    if tel is not None else contextlib.nullcontext():
                store = TokenStore.build(
                    data.doc_texts, max_len=self.spec.p_max_len, chunk=chunk,
                    backing=tcfg.token_backing,
                    cache_dir=doc_cache_dir(tcfg.mmap_dir, index),
                    fingerprint=tcfg.token_fingerprint)
            self._stores[key] = store
            self.store_builds += 1
        return store

    def engine(self, name: str):
        """The (lazily built) engine for one task."""
        if name not in self.tasks:
            raise ValueError(f"unknown task {name!r} "
                             f"(tasks: {', '.join(self.tasks)})")
        eng = self._engines.get(name)
        if eng is None:
            task, data = self.tasks[name], self._data[name]
            tcfg = self._task_cfg(task)
            factory = ENGINES.get(tcfg.engine)
            if getattr(factory, "uses_token_stores", False) \
                    and data.doc_store is None:
                data.doc_store = self._shared_doc_store(task, data, tcfg)
            eng = make_engine(self.spec, data, tcfg)
            self._engines[name] = eng
        return eng

    def build_engines(self) -> None:
        """Eagerly build every task's engine, so a config error fails at
        start-up instead of once per checkpoint."""
        for name in self.tasks:
            self.engine(name)

    def plan_units(self, step: int):
        """The checkpoint's validation work as one
        :class:`~repro_torch.core.workqueue.WorkUnit` per task, in task
        declaration order."""
        units = []
        for name, task in self.tasks.items():
            requires = {"mesh_size": 1}
            requires.update(task.requires or {})
            units.append(WorkUnit.make(step, name, requires))
        return units

    def run_unit(self, params, unit, *, engine=None,
                 write_runs: Optional[bool] = None) -> ValidationResult:
        """Run ONE (step, task) work unit."""
        name = getattr(unit, "task", unit if isinstance(unit, str) else None)
        if name not in self.tasks:
            raise ValueError(f"unknown task {name!r} "
                             f"(tasks: {', '.join(self.tasks)})")
        step, task = int(getattr(unit, "step", 0)), self.tasks[name]
        eng = engine if engine is not None else self.engine(name)
        tel = self.vcfg.telemetry
        if tel is None:
            run, scores, timings = eng.run(params)
        else:
            # one scored span per (step, task); the engine's spans nest
            # under it through the tracer's per-thread parent stack
            with tel.span("scored", step=step, task=name,
                          engine=getattr(eng, "name", ""),
                          score_dtype=getattr(eng, "score_dtype", "f32")):
                run, scores, timings = eng.run(params)
        names = list(task.metrics)
        if task.mode == "average_rank" and "AverageRank" not in names:
            names.append("AverageRank")
        m = metrics_lib.compute_metrics(run, task.qrels, names)
        v = self.vcfg
        do_write = v.write_run if write_runs is None else write_runs
        if do_write and v.output_dir:
            os.makedirs(v.output_dir, exist_ok=True)
            tag = v.run_tag if name == "default" else f"{v.run_tag}.{name}"
            metrics_lib.write_trec_run(
                f"{v.output_dir}/{tag}_step{step}.trec", run, scores,
                tag=tag)
        return ValidationResult(
            step=step, metrics=m, timings=timings,
            subset_size=len(self._data[name].doc_ids),
            engine=getattr(eng, "name", ""),
            score_dtype=getattr(eng, "score_dtype", "f32"), task=name)

    def validate_params(self, params, step: int = 0, *, engine=None,
                        write_runs: Optional[bool] = None) -> SuiteResult:
        """Validate one checkpoint against every task: ``plan_units`` then
        ``run_unit`` per unit.  ``engine`` overrides a one-task suite's
        engine for this call."""
        if engine is not None and len(self.tasks) > 1:
            raise ValueError(
                "a single engine override cannot serve a multi-task suite "
                f"(tasks: {', '.join(self.tasks)}); pass per-task engines "
                "via ValidationSuite(engines={name: engine})")
        out: Dict[str, ValidationResult] = {}
        for unit in self.plan_units(step):
            out[unit.task] = self.run_unit(params, unit, engine=engine,
                                           write_runs=write_runs)
        return SuiteResult(step=step, tasks=out)


def params_from_checkpoint(state: Any) -> Any:
    """Default extractor: trainer saves {"params":..., "opt_state":...}."""
    return state["params"] if isinstance(state, dict) and "params" in state \
        else state
