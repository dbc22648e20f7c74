"""Validator fleet on PyTorch: N workers, one ledger work queue, one
control plane.

The twin of ``examples/fleet_validation.py`` on the port (``repro_torch``).
Validation work is split into claimable **(step, task) work units**
published to the ledger itself, and any number of workers, possibly
heterogeneous, claim, execute and record them.  Everything that
coordinates the fleet lives in ONE append-only JSONL file
(``repro_torch.core.workqueue``), byte for byte the reference's records:
there is no coordinator, a dead worker's lease expires and a peer
reclaims its unit, and the decision history replays offline bit for bit
(in either package).

This walkthrough runs the topology in one process:

  * a **trainer** committing toy-DR checkpoints;
  * a **fleet supervisor** publishing each committed step's units and
    pumping completed steps into a :class:`ControlPlane` (selection and
    claim-aware checkpoint GC);
  * two **heterogeneous worker threads**: a full worker that alone has the
    ``max_depth`` capability the "deep" task requires, and a smoke worker
    that can only run the cheap "dev" task.

The same workers as processes of their own, one task each, are
``python -m repro_torch.launch.fleet --workers N -- python -m
repro_torch.core.cli --worker ...``.

    python examples/fleet_validation_torch.py               # on the GPU
    python examples/fleet_validation_torch.py --device cpu
"""

import argparse
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.control import (ControlConfig, ControlPlane,  # noqa: E402
                                 replay_ledger)
from repro_torch.core.suite import (ValidationConfig,  # noqa: E402
                                    ValidationSuite, ValidationTask)
from repro_torch.core.validator import (ValidationLedger,  # noqa: E402
                                        ValidatorWorker)
from repro_torch.core.workqueue import WorkQueue, replay  # noqa: E402
from repro_torch.data import corpus as corpus_lib  # noqa: E402
from repro_torch.launch.fleet import FleetSupervisor  # noqa: E402
from repro_torch.models.toy import toy_spec, train_toy_dr  # noqa: E402


def main(*, device: str = "cuda", n_passages: int = 600,
         n_queries: int = 60, steps: int = 60, snapshot_every: int = 15,
         workdir: str = None) -> dict:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' (the default) but no CUDA device "
                           "is visible; pass --device cpu to run on the CPU")
    workdir = workdir or tempfile.mkdtemp(prefix="asyncval_fleet_")
    os.makedirs(workdir, exist_ok=True)
    ckdir = os.path.join(workdir, "ckpts")
    ledger_path = os.path.join(workdir, "ledger.jsonl")
    print(f"[fleet] workdir: {workdir}")

    ds = corpus_lib.synthetic_retrieval_dataset(0, n_passages=n_passages,
                                                n_queries=n_queries)
    spec = toy_spec(ds.vocab, device=device)

    # -- the suite: a cheap smoke task plus a deep task only SOME workers
    # are equipped for (requires flow into each unit's claim requirements)
    suite = ValidationSuite(spec, [
        ValidationTask("dev", ds.corpus, ds.queries, ds.qrels,
                       metrics=("MRR@10",), k=100),
        ValidationTask("deep", ds.corpus, ds.queries, ds.qrels,
                       metrics=("MRR@10", "Recall@100"), k=100,
                       requires={"max_depth": 100}),
    ], ValidationConfig(batch_size=128, chunk_size=128))
    suite.build_engines()

    # -- control plane: select on the deep metric, GC to top-3 ---------------
    control = ControlPlane(
        ckdir,
        ControlConfig(metric="deep:MRR@10", mode="max", keep_top_k=3),
        event_path=os.path.join(workdir, "control.jsonl"))

    # -- supervisor: publishes units, pumps completions, claim-aware GC ------
    sup = FleetSupervisor(ckdir, ledger_path, suite.task_names,
                          control=control, plan_units=suite.plan_units,
                          lease_ttl=32)

    # -- two heterogeneous workers ------------------------------------------
    def make_worker(worker_id, capabilities):
        queue = WorkQueue(ledger_path, worker_id,
                          capabilities=capabilities, lease_ttl=32)
        return ValidatorWorker(
            ckdir, suite,
            ledger=ValidationLedger(ledger_path,
                                    expected_tasks=suite.task_names),
            queue=queue, worker_id=worker_id)

    workers = [
        make_worker("full-0", {"mesh_size": 1, "max_depth": 200}),
        make_worker("smoke-0", {"mesh_size": 1}),   # cannot claim "deep"
    ]

    stop = threading.Event()

    def worker_loop(worker):
        while not stop.is_set():
            if not worker.run_once():
                time.sleep(0.02)

    threads = [threading.Thread(target=worker_loop, args=(w,), daemon=True)
               for w in workers]
    for t in threads:
        t.start()

    # -- the trainer: commit checkpoints while the fleet drains them ---------
    print("[fleet] training while 2 workers validate asynchronously...")
    _, snapshots = train_toy_dr(ds, spec, steps=steps,
                                snapshot_every=snapshot_every)
    for step, params in snapshots:
        ckpt.save(ckdir, step, {"params": params})
        sup.run_once()                      # publish + pump + reap
    n_steps = len(snapshots)

    # -- drain: wait until every published step is fully validated -----------
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        sup.run_once()
        state = sup.queue.refresh()
        if len(state.completed_units()) == n_steps * 2:
            break
        time.sleep(0.05)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    # the step that completed the backlog can land between the loop's pump
    # and its check: pump once more, so the control plane has observed
    # every completed step before its decisions are replayed
    sup.run_once()

    # -- what happened -------------------------------------------------------
    led = ValidationLedger(ledger_path, expected_tasks=suite.task_names)
    print(f"[fleet] {len(led.validated_steps)} steps x "
          f"{len(suite.task_names)} tasks validated")
    by_worker = {}
    for row in led.rows():
        by_worker.setdefault(row["worker_id"], []).append(
            (row["step"], row["task"]))
    for wid, units in sorted(by_worker.items()):
        print(f"  {wid}: {len(units)} units -> {sorted(units)}")
    deep_workers = {row["worker_id"] for row in led.rows()
                    if row["task"] == "deep"}
    assert deep_workers == {"full-0"}, \
        "only the max_depth-capable worker may run the deep task"
    print(f"[fleet] best step by {control.cfg.metric}: "
          f"{control.selector.best_step} "
          f"(value {control.selector.best_value:.4f})")

    # -- the ledger IS the coordination record: replay it offline ------------
    state = replay(ledger_path, lease_ttl=32)
    assert state.completed_units() == sorted(
        (s, t) for s in led.validated_steps for t in suite.task_names)
    replayed = replay_ledger(led.rows(), control.cfg,
                             expected_tasks=suite.task_names,
                             group="completion")
    online = [e.to_json() for e in control.events.decisions()]
    offline = [e.to_json() for e in replayed.events.decisions()]
    assert online == offline, "fleet decisions must replay byte-identically"
    print(f"[fleet] {len(online)} control decisions replayed "
          f"byte-identically from the ledger")
    return {"workdir": workdir, "ledger_path": ledger_path,
            "control_path": os.path.join(workdir, "control.jsonl"),
            "validated_steps": led.validated_steps,
            "units_by_worker": {w: sorted(u) for w, u in by_worker.items()},
            "best_step": control.selector.best_step,
            "decisions": online, "task_names": list(suite.task_names),
            "control_cfg": control.cfg}


def _cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    return main(device=args.device, workdir=args.workdir)


if __name__ == "__main__":
    _cli()
