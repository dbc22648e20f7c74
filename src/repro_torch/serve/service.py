"""Query request plane: micro-batching, shared encoder, atomic live index
(``repro/serve/service.py``).

Requests are collected into micro-batches — a batch dispatches when it
reaches ``max_batch`` or when the oldest request has waited ``flush_ms``
(the classic throughput/latency trade) — padded to one fixed
``(max_batch, q_max_len)`` shape, encoded by the live index's checkpoint
and scored through the live :class:`~repro_torch.serve.index.ServingIndex`
at that shape.  The reference searches only the batch's real rows; the
port searches all ``max_batch`` and drops the pad rows after, so the
operands of every call keep one shape (eager PyTorch may sum a product of
another shape in another order).

Two properties the tests lean on:

  * parity — queries are encoded by the encoder the validator runs and
    scored at one fixed shape whatever the batch's fill, so a query's
    embedding, scores and ranking do not depend on how the batch was
    packed;
  * exactly-one-step attribution — the live-index pointer is read once per
    micro-batch and every response in the batch carries that index's
    checkpoint step; a concurrent hot-swap flips the pointer between
    batches, never inside one, so a torn read cannot happen.

On a card the background batcher scores on a CUDA stream of its own, so
its batches never queue behind an index build on the promoter's stream.
A micro-batch holds its index until the answers are on the host (the copy
waits for the batcher's stream), so an index swapped out mid-batch stays
alive until no kernel reads it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import synchronize
from repro_torch.data.corpus import pad_batch
from repro_torch.obs.device import DeviceClock
from repro_torch.serve.admission import AdmissionController, ServeOverloaded
from repro_torch.serve.index import ServingIndex


@dataclasses.dataclass
class ServeResponse:
    """One answered query, stamped with the exact checkpoint that scored
    it — the serving twin of a ledger row's provenance."""
    qid: str
    step: int
    doc_ids: List[str]
    scores: List[float]
    latency_s: float


class _Request:
    __slots__ = ("qid", "tokens", "event", "response", "error", "t0")

    def __init__(self, qid, tokens):
        self.qid = qid
        self.tokens = tokens
        self.event = threading.Event()
        self.response = None
        self.error: Optional[Exception] = None
        self.t0 = time.monotonic()      # submitted, on the tracer's clock


class _Probe:
    """Host readings and device marks of one traced micro-batch, taken on
    the batcher's thread while it scores (``encode``: the query trunk
    starts; ``topk``: ``ServingIndex.topk`` is entered; ``issued``: its
    last launch has returned; ``returned``: the answers are on the host)
    and read only once the batch's answers are released."""

    __slots__ = ("clock", "host", "dev")

    def __init__(self, clock: DeviceClock):
        self.clock = clock
        self.host: Dict[str, float] = {}
        self.dev: Dict[str, Any] = {}

    def mark(self, point: str) -> None:
        self.host[point] = time.monotonic()
        self.dev[point] = self.clock.mark()


class QueryService:
    """Thread-safe query endpoint over a hot-swappable ServingIndex."""

    def __init__(self, spec, *, k: int = 10, max_batch: int = 8,
                 flush_ms: float = 4.0,
                 admission: Optional[AdmissionController] = None,
                 telemetry=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.spec = spec
        self.k = int(k)
        self.max_batch = int(max_batch)
        self.flush_s = float(flush_ms) / 1000.0
        self.admission = admission
        # observation only: per micro-batch a `served` span (with its
        # `encoded` and `topk` children), a `queued` span per request and
        # the occupancy histogram, all emitted after the batch's answers
        # are released; batching and scoring are unchanged
        self.telemetry = telemetry
        self._clock: Optional[DeviceClock] = None
        if telemetry is not None and admission is not None:
            admission.bind_metrics(telemetry.metrics)
        self._cv = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._live: Optional[ServingIndex] = None
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self.served = 0
        self.batches = 0

    # -- live index (the promoter's flip target) ----------------------------
    def install(self, index: ServingIndex) -> Optional[int]:
        """Atomic pointer flip: in-flight micro-batches finish on the old
        index, the next batch reads the new one.  Returns the step that
        was live before (None on first install)."""
        prev = self._live
        self._live = index
        return prev.step if prev is not None else None

    @property
    def live(self) -> Optional[ServingIndex]:
        return self._live

    def live_step(self) -> Optional[int]:
        idx = self._live
        return idx.step if idx is not None else None

    # -- request path -------------------------------------------------------
    def submit(self, qid: str, tokens: Sequence[int], *,
               timeout: float = 30.0) -> ServeResponse:
        """Blocking submit (call from client threads): joins the current
        micro-batch and returns this query's response.  Raises
        :class:`ServeOverloaded` past the admission bound."""
        adm = self.admission
        if adm is not None and not adm.try_acquire():
            raise ServeOverloaded(
                f"{adm.pending} requests in flight (max {adm.max_pending})")
        try:
            req = _Request(qid, tokens)
            with self._cv:
                self._queue.append(req)
                self._cv.notify_all()
            if not req.event.wait(timeout):
                raise TimeoutError(f"query {qid!r} unanswered "
                                   f"after {timeout}s")
        finally:
            if adm is not None:
                adm.release()
        if req.error is not None:
            raise req.error
        return req.response

    def answer(self, items: Sequence[Tuple[str, Sequence[int]]]
               ) -> List[ServeResponse]:
        """Synchronous batch path (one-shot CLI / benches): slices
        ``items`` into ``max_batch`` micro-batches and scores them through
        the identical internals the background loop uses."""
        out: List[ServeResponse] = []
        for lo in range(0, len(items), self.max_batch):
            reqs = [_Request(q, t) for q, t in items[lo:lo + self.max_batch]]
            self._answer(reqs)
            for r in reqs:
                if r.error is not None:
                    raise r.error
                out.append(r.response)
        return out

    # -- micro-batcher ------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stopping = False
        self._thread = threading.Thread(target=self._run,
                                        name="serve-batcher", daemon=True)
        self._thread.start()

    def stop(self, *, timeout: float = 10.0) -> None:
        t = self._thread
        if t is None:
            return
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        t.join(timeout)
        self._thread = None

    def _run(self) -> None:
        device = torch.device(self.spec.device)
        ctx = torch.cuda.stream(torch.cuda.Stream(device)) \
            if device.type == "cuda" else contextlib.nullcontext()
        with ctx:
            if self.telemetry is not None:
                self._anchor_clock()
            self._loop()

    def _anchor_clock(self) -> None:
        """The device clock of the traced batches, anchored on the calling
        thread's stream once it is idle: at the batcher's start, or before
        the first batch of the synchronous path."""
        device = torch.device(self.spec.device)
        synchronize(device)
        clock = DeviceClock(device)
        clock.anchor()
        self._clock = clock

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopping:
                    self._cv.wait(0.05)
                if not self._queue and self._stopping:
                    return
                # max-latency flush: dispatch at max_batch or when the
                # oldest request has waited flush_ms, whichever is first
                deadline = time.monotonic() + self.flush_s
                while len(self._queue) < self.max_batch \
                        and not self._stopping:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(left)
                n = min(self.max_batch, len(self._queue))
                batch = [self._queue.popleft() for _ in range(n)]
            if batch:
                self._answer(batch)

    def _answer(self, reqs: List[_Request]) -> None:
        index = self._live          # read ONCE: one step per micro-batch
        if index is None:
            err = RuntimeError("no live index installed yet")
            for r in reqs:
                r.error = err
                r.event.set()
            return
        tel = self.telemetry
        probe = None
        if tel is not None:
            if self._clock is None:
                self._anchor_clock()
            m0 = time.monotonic()
            probe = _Probe(self._clock)
        try:
            rows = [r.tokens for r in reqs]
            ids, scores = self._score(index, rows) if probe is None \
                else self._score(index, rows, probe)
            now = time.monotonic()
            for r, d, s in zip(reqs, ids, scores):
                r.response = ServeResponse(qid=r.qid, step=index.step,
                                           doc_ids=d, scores=s,
                                           latency_s=now - r.t0)
            self.served += len(reqs)
            self.batches += 1
        except Exception as e:         # fail the batch, not the
            for r in reqs:             # serving loop
                r.error = e
            probe = None
        finally:
            for r in reqs:
                r.event.set()
        if probe is not None:
            self._trace_batch(tel, index, reqs, m0, probe)

    def _trace_batch(self, tel, index: ServingIndex, reqs: List[_Request],
                     m0: float, probe: _Probe) -> None:
        """The spans of one answered batch, emitted after its answers were
        released: its work is on the host, so every mark is complete."""
        released = time.monotonic()
        try:
            occupancy = len(reqs) / self.max_batch
            sid = tel.record("served", m0, released - m0, step=index.step,
                             n=len(reqs), occupancy=occupancy)
            h, dev = probe.host, {p: probe.clock.resolve(m)
                                  for p, m in probe.dev.items()}
            tel.record("encoded", h["encode"], h["topk"] - h["encode"],
                       parent=sid, role="query", dev_t0=dev["encode"],
                       dev_s=dev["topk"] - dev["encode"])
            tel.record("topk", h["topk"], h["returned"] - h["topk"],
                       parent=sid, issue_s=h["issued"] - h["topk"],
                       dev_t0=dev["topk"], dev_s=dev["issued"] - dev["topk"])
            for r in reqs:      # the wait precedes the batch: not a child
                tel.record("queued", r.t0, m0 - r.t0, parent=None,
                           qid=r.qid, batch=sid)
            tel.metrics.histogram("serve.batch_occupancy").observe(
                occupancy)
        except Exception:           # observation never stops the batcher
            tel.metrics.counter("serve.trace_dropped").inc()

    @torch.inference_mode()
    def _score(self, index: ServingIndex, token_rows,
               probe: Optional[_Probe] = None):
        B = len(token_rows)
        toks, mask = pad_batch(list(token_rows), self.spec.q_max_len)
        if B < self.max_batch:
            # one fixed (max_batch, L) shape for every batch size, through
            # the encoder and the search; pad rows are discarded below (rows
            # are independent)
            pad = self.max_batch - B
            toks = np.concatenate(
                [toks, np.zeros((pad, toks.shape[1]), toks.dtype)])
            mask = np.concatenate(
                [mask, np.zeros((pad, mask.shape[1]), mask.dtype)])
        device = torch.device(self.spec.device)
        if probe is not None:
            probe.mark("encode")
        q_emb = self.spec.encode_query(index.params,
                                       torch.from_numpy(toks).to(device),
                                       torch.from_numpy(mask).to(device))
        if probe is None:
            ids, scores = index.search(q_emb, k=self.k)
        else:
            ids, scores = index.search(q_emb, k=self.k, mark=probe.mark)
            probe.host["returned"] = time.monotonic()
        return ids[:B], scores[:B]
