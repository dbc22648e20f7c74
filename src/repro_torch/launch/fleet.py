"""Validator fleet launcher: N workers draining one ledger work queue
(``repro/launch/fleet.py``).

Asyncval moves validation onto "another GPU"; the fleet moves it onto N
workers.  Every shared decision flows through the ledger file (see
:mod:`repro_torch.core.workqueue` for the claim-record schema): workers
claim (step, task) units, the supervisor publishes discovered checkpoints
and feeds completed steps to the control plane, and everything replays
offline, because no decision reads a wall clock.

Two pieces:

  * :class:`FleetSupervisor`, the in-process coordination loop: watches
    the checkpoint root (and, with ``snapshots=``, a hand-off spool),
    publishes each step's work units, pumps completion-grouped
    observations into a :class:`~repro_torch.control.ControlPlane`, and
    runs claim-aware quality GC (a checkpoint under a live lease is never
    deleted, whoever holds it).  It can also spawn and supervise local
    worker processes.
  * ``python -m repro_torch.launch.fleet --workers N -- <worker argv...>``,
    a thin CLI that spawns N copies of a worker command (typically
    ``python -m repro_torch.core.cli --worker ...``) with distinct worker
    ids and restarts crashed ones within a budget.  Heterogeneous fleets
    launch the differing commands directly, or through the API.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.control.metricspec import flatten_rows
from repro_torch.core.watcher import CheckpointWatcher, Policy
from repro_torch.core.workqueue import WorkQueue, WorkUnit


@dataclasses.dataclass
class WorkerProc:
    """One supervised local worker subprocess."""
    worker_id: str
    argv: List[str]
    proc: subprocess.Popen
    restarts: int = 0


class LocalWorkerPool:
    """Spawns and supervises local worker subprocesses."""

    def __init__(self):
        self.workers: List[WorkerProc] = []

    def spawn(self, base_argv: Sequence[str], n: int, *,
              id_prefix: str = "worker") -> List[WorkerProc]:
        """Spawn ``n`` workers running ``base_argv`` with distinct
        ``--worker_id``\\ s appended (``repro_torch.core.cli --worker``
        reads it; custom workers are free to ignore it)."""
        spawned = []
        for i in range(len(self.workers), len(self.workers) + n):
            wid = f"{id_prefix}-{i}"
            argv = list(base_argv) + ["--worker_id", wid]
            wp = WorkerProc(worker_id=wid, argv=argv,
                            proc=subprocess.Popen(argv))
            self.workers.append(wp)
            spawned.append(wp)
        return spawned

    def poll(self, *, max_restarts: int = 0) -> List[WorkerProc]:
        """Reap exited workers; restart crashed ones (rc != 0) within the
        per-worker ``max_restarts`` budget.  A crashed worker's in-flight
        lease simply expires — a surviving peer reclaims the unit, which is
        the fleet's whole crash-tolerance story."""
        restarted = []
        for wp in self.workers:
            rc = wp.proc.poll()
            if rc is None or rc == 0:
                continue
            if wp.restarts < max_restarts:
                wp.restarts += 1
                wp.proc = subprocess.Popen(wp.argv)
                restarted.append(wp)
        return restarted

    def alive(self) -> List[WorkerProc]:
        return [wp for wp in self.workers if wp.proc.poll() is None]

    def shutdown(self, *, timeout_s: float = 10.0) -> List[int]:
        """Terminate every worker; returns their exit codes."""
        for wp in self.workers:
            if wp.proc.poll() is None:
                wp.proc.terminate()
        deadline = time.monotonic() + timeout_s
        codes = []
        for wp in self.workers:
            left = max(0.0, deadline - time.monotonic())
            try:
                codes.append(wp.proc.wait(timeout=left))
            except subprocess.TimeoutExpired:
                wp.proc.kill()
                codes.append(wp.proc.wait())
        return codes


class FleetSupervisor:
    """Publishes work, consumes completions, protects in-flight claims.

    ``plan_units`` maps a committed step to its work units — pass the
    suite's bound :meth:`~repro_torch.core.suite.ValidationSuite.plan_units` so
    unit requirements (``mesh_size`` etc.) match what workers execute; the
    default publishes one requirement-free unit per expected task.

    The supervisor never claims units itself: its queue handle is a
    read-mostly participant whose only appends are unit publications."""

    def __init__(self, ckpt_root: str, ledger_path: str,
                 expected_tasks: Sequence[str], *,
                 control: Any = None,
                 policy: Optional[Policy] = None,
                 plan_units: Optional[Callable[[int],
                                               List[WorkUnit]]] = None,
                 lease_ttl: int = 16, max_abandons: int = 2,
                 extra_protect: Optional[Callable[[], set]] = None,
                 telemetry=None,
                 snapshots: Any = None):
        self.ckpt_root = ckpt_root
        # lazy hand-off spool (repro_torch.handoff.SnapshotSpool): announced
        # snapshot steps publish their units BEFORE the durable COMMIT
        # surfaces via the watcher; workers whose ``snapshots`` source maps
        # the same spool then score from the mmap'd spill.  Publication is
        # keyed (step, task), so the watcher's later discovery of the same
        # step collapses in the fold — first route wins, exactly once.
        self.snapshots = snapshots
        # GC protections beyond fleet state — e.g. the serving tier's
        # Promoter.protect_set (live + mid-promotion checkpoint steps)
        self.extra_protect = extra_protect
        self.expected_tasks = tuple(expected_tasks) or ("default",)
        self.control = control
        # observation only: discovery lag + published/discovered lifecycle
        # events and the fold's fleet.* counter mirrors (see repro_torch.obs)
        self.telemetry = telemetry
        self.queue = WorkQueue(ledger_path, "supervisor",
                               lease_ttl=lease_ttl,
                               max_abandons=max_abandons,
                               telemetry=telemetry)
        self.watcher = CheckpointWatcher(ckpt_root, policy=policy,
                                         telemetry=telemetry)
        self.plan_units = plan_units or (lambda step: [
            WorkUnit.make(step, t) for t in self.expected_tasks])
        self.pool = LocalWorkerPool()
        self._observed = 0          # completion-ordered observations fed

    # -- work publication ---------------------------------------------------
    def publish_pending(self) -> int:
        """Publish every newly announced snapshot's and newly committed
        (policy-selected) step's units.  Idempotent: re-publication after a
        restart — or of a step both routes surface — collapses in the
        fold."""
        n = 0
        if self.snapshots is not None:
            for step in self.snapshots.poll():
                n += len(self.queue.publish(self.plan_units(step),
                                            source="snapshot"))
                # the durable checkpoint may land later; consume its watcher
                # discovery so the policy's skip accounting stays truthful
                self.watcher.mark_seen(step)
        for step in self.watcher.poll():
            n += len(self.queue.publish(self.plan_units(step)))
        return n

    # -- control pump -------------------------------------------------------
    def pump_control(self) -> int:
        """Feed newly COMPLETED steps to the control plane, in completion
        order — the same ``group="completion"`` fold
        ``ControlPlane.replay_ledger`` applies offline, so online and
        replayed decision sequences are byte-identical."""
        if self.control is None:
            return 0
        state = self.queue.refresh()
        obs = flatten_rows(state.result_rows, self.expected_tasks,
                           with_context=True, group="completion")
        fed = 0
        for step, flat, context in obs[self._observed:]:
            self._observed += 1
            try:
                self.control.observe(step, flat, context=context)
            except KeyError:
                continue    # spec metric missing: replay skips identically
            fed += 1
            cfg = self.control.cfg
            if cfg.keep_top_k > 0 and self.control.ckpt_root:
                # durability gate: snapshot-scored evidence defers the
                # irreversible GC until the step's durable commit lands
                self.control.hold_gc_until_durable(
                    step, (context or {}).get("handoff", ""))
                self.control.maybe_gc(self)
        return fed

    def protect_set(self) -> set:
        """Steps GC must keep: committed but not fully validated (minus
        policy skips) — plus anything under a LIVE lease, whichever worker
        holds it: GC'ing a checkpoint mid-restore would turn a peer's
        crash-safe claim into a spurious failure.  ``extra_protect``
        (constructor hook) unions in protections outside the fleet's own
        state — e.g. the checkpoint backing a live serving index."""
        committed = set(ckpt.list_steps(self.ckpt_root))
        state = self.queue.refresh()
        done = {s for s in {u.step for u in
                            (st.unit for st in state.units.values())}
                if state.step_complete(s, self.expected_tasks)}
        protected = committed - done - self.watcher.skipped
        protected |= committed & state.claimed_steps()
        if self.extra_protect is not None:
            protected |= set(self.extra_protect())
        return protected

    def step_complete(self, step: int) -> bool:
        return self.queue.refresh().step_complete(step, self.expected_tasks)

    def run_once(self) -> int:
        """One supervision round: publish, pump, reap workers."""
        self.publish_pending()
        fed = self.pump_control()
        self.poll_workers()
        return fed

    # -- local worker subprocesses (delegated to the pool) -------------------
    @property
    def workers(self) -> List[WorkerProc]:
        return self.pool.workers

    def spawn_workers(self, base_argv: Sequence[str], n: int, *,
                      id_prefix: str = "worker") -> List[WorkerProc]:
        return self.pool.spawn(base_argv, n, id_prefix=id_prefix)

    def poll_workers(self, *, max_restarts: int = 0) -> List[WorkerProc]:
        return self.pool.poll(max_restarts=max_restarts)

    def alive_workers(self) -> List[WorkerProc]:
        return self.pool.alive()

    def shutdown(self, *, timeout_s: float = 10.0) -> List[int]:
        return self.pool.shutdown(timeout_s=timeout_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.fleet",
        description="spawn and supervise N local validator workers: "
                    "everything after '--' is the worker command "
                    "(typically 'python -m repro_torch.core.cli --worker "
                    "...'); "
                    "each copy gets a distinct --worker_id")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--max_restarts", type=int, default=1,
                    help="per-worker restart budget for crashed (rc != 0) "
                         "workers")
    ap.add_argument("--poll_interval", type=float, default=1.0)
    ap.add_argument("worker_argv", nargs=argparse.REMAINDER,
                    help="worker command after '--'")
    args = ap.parse_args(argv)
    base = [a for a in args.worker_argv if a != "--"]
    if not base:
        ap.error("pass the worker command after '--'")
    # supervision only: CLI workers discover + publish units themselves
    # (publication is idempotent), so no ledger path is needed here
    pool = LocalWorkerPool()
    pool.spawn(base, args.workers)
    print(f"[fleet] {args.workers} workers spawned", file=sys.stderr)
    try:
        while pool.alive():
            pool.poll(max_restarts=args.max_restarts)
            time.sleep(args.poll_interval)
    except KeyboardInterrupt:
        pool.shutdown()
    codes = [wp.proc.poll() for wp in pool.workers]
    print(f"[fleet] exit codes: {codes}", file=sys.stderr)
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
