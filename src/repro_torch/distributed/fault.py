"""Fault-tolerance & straggler-mitigation primitives.

At 1000+ nodes the validator's corpus-encode is a bag-of-tasks over chunk
workers; stragglers (slow hosts, pre-emptions) dominate tail latency.  The
classic mitigation (MapReduce "backup tasks") is:

  * **over-decomposition** — split the corpus into ~``over_factor`` x more
    chunks than workers so no worker owns a big indivisible slice;
  * **dynamic work queue** — workers pull, never pre-assigned;
  * **speculative re-execution** — when the queue drains, idle workers
    duplicate the slowest in-flight chunks; first result wins
    (deterministic: both executions produce identical embeddings).

The queue is also the *elasticity* point: workers may join/leave between
chunk pulls (the validator mesh can grow/shrink across checkpoints).

Workers here are threads; the scheduling logic does not depend on what
a worker drives.  This is the reference package's module (it has no device
code) with one repair: a chunk whose executions all failed is not
offered for speculation (the reference takes ``min`` of its empty
in-flight set and raises in the worker thread).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence


@dataclasses.dataclass
class Chunk:
    chunk_id: int
    payload: Any


@dataclasses.dataclass
class ChunkResult:
    chunk_id: int
    value: Any
    worker: str
    duration_s: float
    speculative: bool = False


def make_chunks(items: Sequence[Any], n_workers: int,
                over_factor: int = 4) -> List[Chunk]:
    """Over-decompose ``items`` into ~n_workers*over_factor chunks."""
    n = len(items)
    n_chunks = max(1, min(n, n_workers * over_factor))
    size = -(-n // n_chunks)
    return [Chunk(i, items[s:s + size])
            for i, s in enumerate(range(0, n, size))]


class WorkQueue:
    """Thread-safe dynamic queue with speculative duplicate execution."""

    def __init__(self, chunks: Sequence[Chunk], *, speculate: bool = True,
                 max_attempts: int = 3):
        self._lock = threading.Lock()
        self._pending: List[Chunk] = list(chunks)
        self._inflight: Dict[int, Dict[str, float]] = {}   # id -> {worker: t0}
        self._done: Dict[int, ChunkResult] = {}
        self._failures: Dict[int, int] = {}
        self._chunk_by_id = {c.chunk_id: c for c in chunks}
        self._total = len(chunks)
        self.speculate = speculate
        self.max_attempts = max_attempts

    # -- worker API ----------------------------------------------------------
    def acquire(self, worker: str) -> Optional[Chunk]:
        """Next chunk for ``worker``; a speculative duplicate of the oldest
        in-flight chunk when the primary queue is drained; None when done."""
        with self._lock:
            if self._pending:
                c = self._pending.pop(0)
                self._inflight.setdefault(c.chunk_id, {})[worker] = time.time()
                return c
            if self.speculate:
                # duplicate the longest-running chunk this worker isn't on
                # (a chunk whose every execution failed has none running)
                cands = [(min(ts.values()), cid)
                         for cid, ts in self._inflight.items()
                         if cid not in self._done and ts
                         and worker not in ts]
                if cands:
                    _, cid = min(cands)
                    self._inflight[cid][worker] = time.time()
                    return Chunk(cid, self._chunk_by_id[cid].payload)
            return None

    def complete(self, worker: str, chunk_id: int, value: Any) -> bool:
        """Record a result. Returns True iff this execution 'won' (first)."""
        with self._lock:
            t0 = self._inflight.get(chunk_id, {}).get(worker, time.time())
            if chunk_id in self._done:
                self._inflight.get(chunk_id, {}).pop(worker, None)
                return False
            spec = len(self._inflight.get(chunk_id, {})) > 1
            self._done[chunk_id] = ChunkResult(
                chunk_id, value, worker, time.time() - t0, speculative=spec)
            self._inflight.pop(chunk_id, None)
            return True

    def fail(self, worker: str, chunk_id: int, err: Any = None) -> None:
        """Worker died / raised: requeue unless the chunk already completed
        or exceeded max_attempts (then it surfaces via ``failed_chunks``)."""
        with self._lock:
            self._inflight.get(chunk_id, {}).pop(worker, None)
            if chunk_id in self._done:
                return
            self._failures[chunk_id] = self._failures.get(chunk_id, 0) + 1
            if self._failures[chunk_id] < self.max_attempts \
                    and not self._inflight.get(chunk_id):
                self._pending.append(self._chunk_by_id[chunk_id])

    # -- status ----------------------------------------------------------------
    @property
    def finished(self) -> bool:
        with self._lock:
            return len(self._done) == self._total

    @property
    def failed_chunks(self) -> List[int]:
        with self._lock:
            return [cid for cid, n in self._failures.items()
                    if n >= self.max_attempts and cid not in self._done]

    def results(self) -> List[ChunkResult]:
        with self._lock:
            return [self._done[cid] for cid in sorted(self._done)]


def run_chunked(items: Sequence[Any], fn: Callable[[Any], Any], *,
                n_workers: int = 4, over_factor: int = 4,
                speculate: bool = True,
                worker_delay: Optional[Callable[[str], float]] = None,
                fail_once: Sequence[int] = ()) -> List[Any]:
    """Execute ``fn(chunk.payload)`` over all chunks with the full straggler/
    fault machinery; returns per-chunk values in chunk order.

    ``worker_delay``/``fail_once`` are test hooks simulating slow and crashing
    workers (chunk ids in ``fail_once`` raise on their first execution).
    """
    chunks = make_chunks(items, n_workers, over_factor)
    queue = WorkQueue(chunks, speculate=speculate)
    failed_once = set()
    errors: List[BaseException] = []

    def worker(name: str):
        while True:
            c = queue.acquire(name)
            if c is None:
                if queue.finished or queue.failed_chunks or errors:
                    return
                time.sleep(0.001)
                continue
            try:
                if worker_delay is not None:
                    time.sleep(worker_delay(name))
                if c.chunk_id in fail_once and c.chunk_id not in failed_once:
                    failed_once.add(c.chunk_id)
                    raise RuntimeError(f"injected failure on {c.chunk_id}")
                queue.complete(name, c.chunk_id, fn(c.payload))
            except BaseException as e:
                if isinstance(e, RuntimeError) and "injected" in str(e):
                    queue.fail(name, c.chunk_id, e)
                else:
                    errors.append(e)
                    queue.fail(name, c.chunk_id, e)

    threads = [threading.Thread(target=worker, args=(f"w{i}",))
               for i in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    if queue.failed_chunks:
        raise RuntimeError(f"chunks failed permanently: {queue.failed_chunks}")
    return [r.value for r in queue.results()]
