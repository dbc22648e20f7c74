"""Checkpoint-lifecycle telemetry on PyTorch: trace a whole asyncval run.

The twin of ``examples/observability.py`` on the port (``repro_torch``).
Every stage a checkpoint moves through (``produced`` by the trainer,
``discovered`` by the watcher, ``published`` / ``claimed`` through the
fleet work queue, ``store_build`` / ``staged`` / ``encoded`` / ``scored`` /
``recorded`` inside validation, ``selected`` by the control plane,
``promoted`` and ``served`` by the serving tier) is recorded as a span or
event in per-process JSONL trace files (``repro_torch.obs``, the
reference's record format), merged into one Chrome trace-event JSON for
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

This walkthrough runs the topology in one process:

  * a :class:`~repro_torch.train.trainer.Trainer` committing smoke
    dr-bert-base checkpoints (``produced`` events) and publishing each
    one's params into a :class:`~repro_torch.handoff.SnapshotChannel`
    (``snapshotted`` events: the hand-off's stage, which the reference's
    walkthrough, written before the hand-off existed, does not produce
    and so fails its own every-stage assert on);
  * a fleet supervisor (watcher + control plane) publishing each step's
    units and selecting the best checkpoint;
  * two validator workers, each with its OWN tracer (distinct
    ``worker_id``), sharing one ledger work queue;
  * a serving tier promoting the control plane's pick and answering
    queries off it.

Afterwards it exports the merged Chrome trace and prints the per-stage
latency breakdown and the metrics report with the checkpoint-to-verdict
p50 / p99.

    python examples/observability_torch.py               # on the GPU
    python examples/observability_torch.py --device cpu
"""

import argparse
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.control import ControlConfig, ControlPlane  # noqa: E402
from repro_torch.core.suite import (ValidationConfig,  # noqa: E402
                                    ValidationSuite, ValidationTask)
from repro_torch.core.validator import (CKPT_TO_VERDICT_METRIC,  # noqa: E402
                                        ValidationLedger, ValidatorWorker)
from repro_torch.core.workqueue import WorkQueue  # noqa: E402
from repro_torch.data import corpus as corpus_lib  # noqa: E402
from repro_torch.handoff import SnapshotChannel  # noqa: E402
from repro_torch.launch.fleet import FleetSupervisor  # noqa: E402
from repro_torch.launch.train import _contrastive_batches  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.biencoder import (biencoder_spec,  # noqa: E402
                                          contrastive_loss)
from repro_torch.obs import (LIFECYCLE_STAGES, MetricsRegistry,  # noqa: E402
                             Telemetry)
from repro_torch.obs.export import (breakdown_table,  # noqa: E402
                                    load_traces, write_chrome)
from repro_torch.serve import (AdmissionController,  # noqa: E402
                               IndexBuilder, Promoter, QueryService,
                               ServeConfig)
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


def main(*, device: str = "cuda", n_passages: int = 400, n_queries: int = 40,
         total_steps: int = 40, ckpt_every: int = 10,
         workdir: str = None) -> dict:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' (the default) but no CUDA device "
                           "is visible; pass --device cpu to run on the CPU")
    workdir = workdir or tempfile.mkdtemp(prefix="asyncval_obs_")
    os.makedirs(workdir, exist_ok=True)
    ckdir = os.path.join(workdir, "ckpts")
    ledger_path = os.path.join(workdir, "ledger.jsonl")
    print(f"[obs] workdir: {workdir}")

    # one shared registry: the trainer, supervisor, workers and serving
    # tier aggregate into one report, while each component writes its OWN
    # trace file (merged at export time)
    registry_shared = MetricsRegistry()

    def telemetry(name):
        return Telemetry(os.path.join(workdir, f"trace_{name}.jsonl"),
                         registry=registry_shared, process=name,
                         attrs={"worker_id": name})

    tel_main = telemetry("main")

    # -- model + data --------------------------------------------------------
    cfg = registry.get("dr-bert-base").smoke_config()
    spec = biencoder_spec(cfg, q_max_len=12, p_max_len=28, device=device)
    ds = corpus_lib.synthetic_retrieval_dataset(0, n_passages=n_passages,
                                                n_queries=n_queries,
                                                vocab=cfg.vocab_size)
    mesh_size = torch.cuda.device_count() if device == "cuda" else 1

    # -- two fleet workers, each tracing to its own file ---------------------
    def make_worker(wid):
        tel = telemetry(wid)
        vcfg = ValidationConfig(metrics=("MRR@10", "Recall@100"),
                                batch_size=32, telemetry=tel)
        suite = ValidationSuite(spec, [
            ValidationTask("default", ds.corpus, ds.queries, ds.qrels)],
            vcfg)
        queue = WorkQueue(ledger_path, wid, lease_ttl=32,
                          capabilities={"mesh_size": mesh_size},
                          telemetry=tel)
        return ValidatorWorker(
            ckdir, suite,
            ledger=ValidationLedger(ledger_path,
                                    expected_tasks=suite.task_names,
                                    telemetry=tel),
            queue=queue, worker_id=wid, telemetry=tel), suite, tel

    w0, suite, _ = make_worker("w0")
    w1, _, _ = make_worker("w1")

    # -- control plane + supervisor (watcher publishes, control selects) ----
    control = ControlPlane(
        ckdir, ControlConfig(metric="MRR@10", mode="max"),
        event_path=os.path.join(workdir, "control.jsonl"),
        telemetry=tel_main)
    sup = FleetSupervisor(ckdir, ledger_path, suite.task_names,
                          control=control, plan_units=suite.plan_units,
                          lease_ttl=32, telemetry=tel_main)

    stop = threading.Event()

    def worker_loop(worker):
        while not stop.is_set():
            if not worker.run_once():
                time.sleep(0.02)

    threads = [threading.Thread(target=worker_loop, args=(w,), daemon=True)
               for w in (w0, w1)]
    for t in threads:
        t.start()

    # -- train: the Trainer emits a `produced` event per commit --------------
    print("[obs] training while 2 traced workers validate asynchronously...")
    params = tfm.params_from_numpy(tfm.init_numpy(cfg, 0), device)
    trainer = Trainer(
        TrainerConfig(total_steps=total_steps, ckpt_every=ckpt_every,
                      ckpt_dir=ckdir, log_every=ckpt_every,
                      async_save=False,
                      snapshots=SnapshotChannel(capacity=2,
                                                telemetry=tel_main)),
        lambda p, b: contrastive_loss(p, spec, b),
        optim.adamw(2e-3), params,
        _contrastive_batches(ds, spec, 16), telemetry=tel_main)
    trainer.run()

    # -- drain the fleet backlog --------------------------------------------
    n_ckpts = total_steps // ckpt_every
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        sup.run_once()                      # discover + publish + pump
        state = sup.queue.refresh()
        if len(state.completed_units()) == n_ckpts:
            break
        time.sleep(0.05)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    sup.run_once()                          # pump the last completions

    # -- serve off the control plane's pick (promoted + served spans) -------
    service = QueryService(spec, k=10, max_batch=8,
                           admission=AdmissionController(64),
                           telemetry=tel_main)
    promoter = Promoter(
        IndexBuilder(spec, ds.corpus, ServeConfig(k=10, batch_size=32)),
        service, ckdir,
        target_fn=lambda: control.selector.best_step,
        log=os.path.join(workdir, "serve.jsonl"), telemetry=tel_main)
    assert promoter.poll_once(), "promotion of the selected step failed"
    responses = service.answer(sorted(ds.queries.items())[:16])
    print(f"[obs] served {len(responses)} queries from step "
          f"{service.live_step()} (best by {control.cfg.metric}: "
          f"step {control.selector.best_step})")

    # -- export: one merged Chrome trace over all the timelines -------------
    for w in (w0, w1):
        w.telemetry.flush()
    tel_main.flush()
    traces = sorted(os.path.join(workdir, f) for f in os.listdir(workdir)
                    if f.startswith("trace_"))
    chrome = os.path.join(workdir, "lifecycle_trace.json")
    doc = write_chrome(traces, chrome)
    records = load_traces(traces)
    seen = {r["name"] for r in records}
    missing = [s for s in LIFECYCLE_STAGES if s not in seen]
    assert not missing, f"lifecycle stages missing from trace: {missing}"
    workers_tracing = {r.get("worker_id") for r in records
                       if r["name"] == "scored"}
    assert len(workers_tracing) >= 2, "expected scored spans from 2 workers"
    print(f"\n[obs] wrote {chrome} ({len(doc['traceEvents'])} events; "
          f"open in https://ui.perfetto.dev)")
    print(f"[obs] all {len(LIFECYCLE_STAGES)} lifecycle stages traced "
          f"across workers {sorted(workers_tracing)}\n")

    # -- per-stage latency breakdown (inclusive vs self time) ----------------
    print(breakdown_table(records))

    # -- the metrics report (what `repro_torch.core.cli --obs_report`
    # prints); fleet.* counters are per-handle mirrors of the ledger fold:
    # three queue handles share this registry, so they read 3x the units
    print()
    print(registry_shared.render())
    hist = registry_shared.get(CKPT_TO_VERDICT_METRIC)
    p50, p99 = hist.percentile(50), hist.percentile(99)
    print(f"\n[obs] checkpoint-to-verdict: p50={p50:.3f}s "
          f"p99={p99:.3f}s over {hist.count} verdicts")
    return {"workdir": workdir, "traces": traces, "chrome": chrome,
            "n_events": len(doc["traceEvents"]), "stages": sorted(seen),
            "workers_tracing": sorted(workers_tracing),
            "served_step": service.live_step(),
            "ckpt_to_verdict_p50_s": p50, "ckpt_to_verdict_p99_s": p99,
            "n_verdicts": hist.count}


def _cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    return main(device=args.device, workdir=args.workdir)


if __name__ == "__main__":
    _cli()
