"""Promotion plane: control-plane select events -> zero-downtime hot-swap
(``repro/serve/promoter.py``).

The promoter closes the loop the control plane opens: the selector emits
fsync'd ``select`` events naming the best checkpoint so far; the promoter
tails them and swaps the live serving index in two phases mirroring
``ckpt.save``'s commit discipline:

  1. build   — restore the checkpoint, encode the corpus into a fresh
     :class:`~repro_torch.serve.index.ServingIndex` OFF to the side (queries
     keep answering on the old index the whole time);
  2. verify + flip — probe the candidate (shape/finiteness/canary
     search), then atomically flip the service's live pointer.  A failure
     anywhere leaves the old index serving and is recorded as
     ``swap_failed``.

Every swap appends a ``swap`` actuation event (checkpoint step, previous
step, engine, ``score_dtype``, corpus size, build seconds) to an
append-only fsync'd :class:`~repro_torch.control.events.ControlEventLog`, so
the live-step timeline is replayable offline (:func:`replay_swaps`).

Desired-step sources, in precedence order: an injected ``target_fn``
(in-process control planes pass ``lambda: selector.best_step``), tailing
a control event JSONL file for ``select`` events, else the latest
committed checkpoint.  The promoter re-reads the LATEST desired step each
poll, so a select event arriving during an in-flight build coalesces —
the next poll jumps straight to the newest winner instead of queueing
intermediate swaps.

A divergence by design: the checkpoint is restored with the port's
key-path ``template`` (default ``{"params": <the encoder's param
shapes>}``), where the reference takes ``shardings``.  The restored tree
lands on the CPU; the build uploads it on the builder's own CUDA stream,
and the verify runs there too.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional, Tuple, Union

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.control.events import ControlEventLog
from repro_torch.core.jsonl import read_jsonl_tolerant
from repro_torch.core.suite import params_from_checkpoint
from repro_torch.serve.index import IndexBuilder, ServingIndex
from repro_torch.serve.service import QueryService


class Promoter:
    """Two-phase hot-swapper between a builder and a query service."""

    def __init__(self, builder: IndexBuilder, service: QueryService,
                 ckpt_root: str, *,
                 target_fn: Optional[Callable[[], Optional[int]]] = None,
                 control_events: Optional[str] = None,
                 log: Union[ControlEventLog, str, None] = None,
                 params_extractor: Callable = params_from_checkpoint,
                 template: Optional[dict] = None,
                 poll_interval_s: float = 0.2,
                 build_hook: Optional[Callable[[int], None]] = None,
                 telemetry=None):
        # observation only: a `promoted` span per successful swap (restore →
        # build → verify → flip) and a serve.promote_s histogram; swap
        # decisions and the event log are identical with telemetry off
        self.telemetry = telemetry
        self.builder = builder
        self.service = service
        self.ckpt_root = ckpt_root
        self.target_fn = target_fn
        self.control_events = control_events
        self.log = log if isinstance(log, ControlEventLog) \
            else ControlEventLog(log)
        self.params_extractor = params_extractor
        self.template = template if template is not None \
            else {"params": builder.spec.param_shapes}
        self.poll_interval_s = poll_interval_s
        self.build_hook = build_hook     # test seam: runs post-build,
                                         # pre-verify (inject faults/events)
        self.swaps: List[Tuple[Optional[int], int]] = []
        self.failures: List[Tuple[int, Exception]] = []
        self._promoting: Optional[int] = None
        self._consumed = 0               # control-event rows already read
        self._last_select: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._stopping = False

    # -- desired step -------------------------------------------------------
    def desired_step(self) -> Optional[int]:
        """The newest target, re-derived every call — which is exactly the
        coalescing rule: N select events between two polls collapse into
        one swap to the final winner."""
        if self.target_fn is not None:
            return self.target_fn()
        if self.control_events:
            if os.path.exists(self.control_events):
                recs, _ = read_jsonl_tolerant(self.control_events,
                                              kind="control event")
                for rec in recs[self._consumed:]:
                    self._consumed += 1
                    if rec.get("kind") != "select":
                        continue
                    best = rec.get("best_step", rec.get("step"))
                    if best is not None:
                        self._last_select = int(best)
            return self._last_select
        return ckpt.latest_step(self.ckpt_root)

    # -- GC contract --------------------------------------------------------
    def protect_set(self) -> set:
        """Steps quality GC must never delete: the checkpoint BACKING the
        live index (rollback target + restart source) and the one an
        in-flight promotion is building from.  Plug into
        ``AsyncValidator``'s ``extra_protect``."""
        out = set()
        live = self.service.live_step()
        if live is not None:
            out.add(live)
        if self._promoting is not None:
            out.add(self._promoting)
        return out

    # -- two-phase swap -----------------------------------------------------
    def verify(self, index: ServingIndex) -> None:
        """Phase-two gate, before the flip: structural checks plus a
        canary search.  Finiteness is read on the resident dtype, without
        an f32 copy of the matrix."""
        if index.n_docs < 1:
            raise ValueError("candidate index is empty")
        if index.n_docs != len(index.doc_ids):
            raise ValueError(
                f"candidate index rows ({index.n_docs}) != doc ids "
                f"({len(index.doc_ids)})")
        if not index.finite():
            raise ValueError("candidate index has non-finite embeddings")
        canary = torch.zeros((1, int(index.emb.shape[1])),
                             device=index.device)
        ids, _ = index.search(canary,
                              k=min(self.service.k, index.n_docs))
        if not ids or not ids[0]:
            raise ValueError("candidate index answered an empty canary")

    def poll_once(self) -> bool:
        """One promotion attempt; True iff the live index was swapped.
        Single-threaded by design — the poll loop is the swap mutex, and
        a failed build leaves the previous index serving untouched."""
        want = self.desired_step()
        live = self.service.live_step()
        if want is None or want == live:
            return False
        if want not in ckpt.list_steps(self.ckpt_root):
            return False                 # selected but not yet durable
        self._promoting = want
        tel = self.telemetry
        m0 = time.monotonic() if tel is not None else 0.0
        try:
            state, _ = ckpt.restore(self.ckpt_root, want,
                                    template=self.template)
            params = self.params_extractor(state)
            index = self.builder.build(params, want)
            if self.build_hook is not None:
                self.build_hook(want)
            with self.builder.on_stream():
                self.verify(index)
            prev = self.service.install(index)
            self.log.emit("swap", want,
                          prev_step=prev if prev is not None else -1,
                          engine="serve",
                          score_dtype=index.score_dtype,
                          impl=index.impl, n_docs=int(index.n_docs),
                          build_s=round(float(index.build_s), 6))
            self.swaps.append((prev, want))
            if tel is not None:
                dur = time.monotonic() - m0
                tel.record("promoted", m0, dur, step=want,
                           prev=prev if prev is not None else -1,
                           n_docs=index.n_docs,
                           build_s=round(index.build_s, 6))
                tel.metrics.histogram("serve.promote_s").observe(dur)
            return True
        except Exception as e:           # the old index serves on
            self.failures.append((want, e))
            self.log.emit("swap_failed", want,
                          error=f"{type(e).__name__}: {e}",
                          engine="serve",
                          score_dtype=self.builder.cfg.score_dtype,
                          live_step=live if live is not None else -1)
            return False
        finally:
            self._promoting = None

    # -- background loop ----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stopping = False
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-promoter", daemon=True)
        self._thread.start()

    def stop(self, *, timeout: float = 30.0) -> None:
        t = self._thread
        if t is None:
            return
        self._stopping = True
        t.join(timeout)
        self._thread = None

    def _loop(self) -> None:
        while not self._stopping:
            try:
                self.poll_once()
            except Exception:            # never kill serving
                pass
            time.sleep(self.poll_interval_s)


def replay_swaps(path: str) -> List[dict]:
    """Re-derive the live-step timeline from a serve event log: one row
    per successful swap, ``{"seq", "step", "prev_step"}`` in order.  An
    auditor can join this against response attributions to prove every
    answer came from a then-live promoted checkpoint."""
    log = ControlEventLog(path)
    out = []
    for ev in log.events():
        if ev.kind == "swap":
            out.append({"seq": ev.seq, "step": ev.step,
                        "prev_step": ev.payload.get("prev_step", -1)})
    return out
