"""Lazy snapshot hand-off on PyTorch: validate checkpoints BEFORE they are
durable.

The twin of ``examples/lazy_handoff.py`` on the port (``repro_torch``).
The classic hand-off is the filesystem: the trainer's two-phase
``ckpt.save`` commits, and the validator's watcher discovers the COMMIT
marker on its next poll.  The lazy hand-off (``repro_torch.handoff``)
takes both off the critical path: the moment ``ckpt.AsyncSaver``'s
device-to-host copy lands, before a byte is fsync'd, a
:class:`ParamSnapshot` goes into a bounded :class:`SnapshotChannel`; the
validator wakes on the publish, scores the snapshot and writes its ledger
row with ``handoff="snapshot"`` while the durable save is still running.

The contracts shown:

  * **bit-parity**: re-validating a step from its durable checkpoint gives
    the snapshot verdict bit for bit;
  * **training never blocks**: the channel drops the oldest unclaimed
    snapshot under backpressure (the watcher scores dropped steps later);
  * **the measured win**: one checkpoint cadence run twice, and the
    checkpoint-to-verdict p50 (``validate.ckpt_to_verdict_s``) printed for
    the watcher route and the snapshot route.

    python examples/lazy_handoff_torch.py               # on the GPU
    python examples/lazy_handoff_torch.py --device cpu

CLI equivalent: ``python -m repro_torch.launch.train --handoff`` (add
``--handoff-spool DIR`` for validator processes reading it through
``repro_torch.core.cli --handoff_spool DIR``).
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.core.suite import (ValidationConfig,  # noqa: E402
                                    ValidationSuite, ValidationTask)
from repro_torch.core.validator import (CKPT_TO_VERDICT_METRIC,  # noqa: E402
                                        AsyncValidator, ValidationLedger,
                                        ValidatorWorker)
from repro_torch.data import corpus as corpus_lib  # noqa: E402
from repro_torch.handoff import ParamSnapshot, SnapshotChannel  # noqa: E402
from repro_torch.models.toy import toy_spec, train_toy_dr  # noqa: E402
from repro_torch.obs import Telemetry  # noqa: E402


def build_suite(ds, spec):
    return ValidationSuite(spec, [
        ValidationTask("default", ds.corpus, ds.queries, ds.qrels),
    ], ValidationConfig(metrics=("MRR@10",), k=50, batch_size=64))


def run_route(snaps, ds, spec, *, handoff: bool, root: str):
    """Replay one checkpoint cadence through one hand-off route."""
    workdir = tempfile.mkdtemp(
        prefix=f"asyncval_{'handoff' if handoff else 'watcher'}_", dir=root)
    ckdir = os.path.join(workdir, "ckpts")
    tel = Telemetry(None)       # metrics only: no trace file needed
    channel = SnapshotChannel(capacity=4, telemetry=tel) \
        if handoff else None
    validator = AsyncValidator(ckdir, build_suite(ds, spec),
                               poll_interval_s=0.05, telemetry=tel,
                               snapshots=channel)
    validator.start()
    saver = ckpt.AsyncSaver()
    try:
        for step, params in snaps:
            state = {"params": params}
            tel.mark("produced", step)
            if channel is not None:
                # the trainer's async-saver hook wiring: publish the host
                # copy first, commit durably behind it
                saver.save(ckdir, step, state,
                           on_host_copy=lambda s, host: channel.publish(
                               ParamSnapshot.from_tree(s, host)),
                           on_durable=channel.mark_durable,
                           on_failure=channel.mark_failed)
            else:
                saver.save(ckdir, step, state)
            # wait the verdict out, as a trainer's next phase would: each
            # step's latency is the route's cost, not a backlog's
            deadline = time.monotonic() + 60.0
            while step not in validator.ledger:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"no verdict for step {step}")
                time.sleep(0.005)
        saver.wait()
    finally:
        validator.stop(drain=True)
    hist = tel.metrics.get(CKPT_TO_VERDICT_METRIC)
    p50 = hist.percentile(50) if hist is not None and hist.count else None
    return validator, workdir, ckdir, p50


def main(*, device: str = "cuda", n_passages: int = 500,
         n_queries: int = 50, steps: int = 120, snapshot_every: int = 30,
         workdir: str = None) -> dict:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' (the default) but no CUDA device "
                           "is visible; pass --device cpu to run on the CPU")
    workdir = workdir or tempfile.mkdtemp(prefix="asyncval_lazy_")
    os.makedirs(workdir, exist_ok=True)
    ds = corpus_lib.synthetic_retrieval_dataset(0, n_passages=n_passages,
                                                n_queries=n_queries)
    spec = toy_spec(ds.vocab, device=device)
    # one training run, one checkpoint cadence, replayed through BOTH
    # routes so the latency comparison scores identical params
    _, snaps = train_toy_dr(ds, spec, steps=steps,
                            snapshot_every=snapshot_every)
    snaps = [(s, p) for s, p in snaps if s > 0]
    print(f"[train] {len(snaps)} checkpoints on a {snapshot_every}-step "
          "cadence")

    # -- route 1: the classic watcher path (durable commit -> poll) --------
    v_watch, _, _, watcher_p50 = run_route(snaps, ds, spec, handoff=False,
                                           root=workdir)
    print(f"[watcher] {len(v_watch.results)} verdicts, "
          f"ckpt-to-verdict p50 = {watcher_p50:.3f}s")

    # -- route 2: the lazy snapshot hand-off -------------------------------
    v_hand, _, ckdir, handoff_p50 = run_route(snaps, ds, spec, handoff=True,
                                              root=workdir)
    rows = v_hand.ledger.rows()
    n_snap = sum(1 for r in rows if r.get("handoff") == "snapshot")
    print(f"[handoff] {len(v_hand.results)} verdicts "
          f"({n_snap} scored pre-durable), "
          f"ckpt-to-verdict p50 = {handoff_p50:.3f}s")

    # -- the measured win --------------------------------------------------
    gap = watcher_p50 / handoff_p50
    print(f"[handoff] verdict latency gap: {gap:.1f}x faster "
          f"({watcher_p50:.3f}s -> {handoff_p50:.3f}s)")

    # -- bit-parity: re-score each snapshot-validated step from its durable
    # checkpoint and compare verdicts exactly
    snap_steps = [r["step"] for r in rows if r.get("handoff") == "snapshot"]
    parity = {}
    if snap_steps:
        step = snap_steps[-1]
        suite = build_suite(ds, spec)
        worker = ValidatorWorker(
            ckdir, suite,
            ledger=ValidationLedger(None, expected_tasks=suite.task_names))
        durable = worker.run_step(step)
        snap_row = next(r for r in rows if r["step"] == step)
        assert durable.tasks["default"].metrics == snap_row["metrics"], \
            "snapshot verdict must be bit-identical to durable restore"
        parity = {"step": step, "metrics": snap_row["metrics"]}
        print(f"[parity] step {step}: snapshot == durable "
              f"({snap_row['metrics']})")
    return {"workdir": workdir, "ckpts_dir": ckdir,
            "watcher_p50_s": watcher_p50, "handoff_p50_s": handoff_p50,
            "gap": gap, "n_verdicts": len(v_hand.results),
            "n_snapshot": n_snap, "rows": rows, "parity": parity}


def _cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    return main(device=args.device, workdir=args.workdir)


if __name__ == "__main__":
    _cli()
