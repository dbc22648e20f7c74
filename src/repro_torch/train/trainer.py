"""Training loop with checkpoint/restart, async saving and metric logging
(``repro/train/trainer.py``).

The trainer is the *producer* side of Asyncval: it trains, commits a
checkpoint to ``ckpt_dir`` every ``ckpt_every`` steps (two-phase commit, in
the reference's format, so either package resumes from or validates the
other's checkpoints) and never waits for validation.  The validator
(:mod:`repro_torch.core.validator`) is the consumer.

The step is eager PyTorch: ``torch.autograd.grad`` of the loss over the
parameter leaves, then the functional optimizer (:mod:`repro_torch.train.
optim`), which returns new tensors, so :class:`~repro_torch.ckpt.
checkpoint.AsyncSaver` can copy a step's state while later steps run.

Two couplings to the validator's side, both optional: ``stop_file``, the
control plane's STOP marker, polled between steps (training halts
asynchronously, it never waits on validation), and ``snapshots``, a
:class:`~repro_torch.handoff.SnapshotChannel` that receives each
checkpoint's params as a host snapshot the moment the saver's
device-to-host copy lands, before the durable write.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.control.earlystop import stop_requested
from repro_torch.core import pytree
from repro_torch.handoff import ParamSnapshot
from repro_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 10
    ckpt_dir: Optional[str] = None
    keep_last: int = 0              # 0 = keep all (validator may lag)
    log_every: int = 10
    async_save: bool = True
    grad_accum: int = 1
    # the control plane's STOP marker, polled every stop_poll_every steps
    stop_file: Optional[str] = None
    stop_poll_every: int = 1
    # lazy snapshot hand-off (repro_torch.handoff.SnapshotChannel): each
    # saved step's params are published as a host snapshot; None keeps the
    # durable-only hand-off
    snapshots: Any = None


def _grads(loss_fn: Callable, leaves, treedef, batch):
    """``(loss, aux, grads)`` of ``loss_fn(params, batch)`` at ``leaves``;
    a leaf the loss does not read gets a zero gradient, as under
    ``jax.grad``."""
    xs = [leaf.detach().requires_grad_(True) for leaf in leaves]
    with torch.enable_grad():
        loss, aux = loss_fn(treedef.unflatten(xs), batch)
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, gs)]
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, gs


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    grad_accum: int = 1):
    """Build ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.

    ``loss_fn(params, batch) -> (loss, aux)``.  With ``grad_accum > 1`` the
    batch's leading axis is split into that many microbatches; losses and
    gradients (in f32) are averaged and ``aux`` is the last microbatch's,
    as the reference's ``lax.scan`` gives them."""

    def step(params, opt_state, batch):
        leaves, treedef = pytree.tree_flatten(params)
        if grad_accum <= 1:
            loss, aux, gs = _grads(loss_fn, leaves, treedef, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            gs = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for p in leaves]
            micro = pytree.tree_map(
                lambda x: x.reshape((grad_accum, x.shape[0] // grad_accum)
                                    + tuple(x.shape[1:])), batch)
            for i in range(grad_accum):
                mb = pytree.tree_map(lambda x: x[i], micro)
                l, aux, g = _grads(loss_fn, leaves, treedef, mb)
                loss = loss + l
                gs = [a + b for a, b in zip(gs, g)]
            loss = loss / grad_accum
            gs = [g / grad_accum for g in gs]
        new_params, new_opt_state = optimizer.update(
            treedef.unflatten(gs), opt_state, params)
        return new_params, new_opt_state, {"loss": loss, **aux}

    return step


def _template(tree):
    """A restore template of ``tree``: its nested dicts with each leaf's
    shape."""
    return pytree.tree_map(lambda t: tuple(t.shape), tree)


class Trainer:
    """End-to-end trainer; runs on the device its ``init_params`` live on.

    Resumable: on construction it restores the newest committed checkpoint
    that is not virtual (params, optimizer state and step; the batches are
    a function of the step), written by either package.  Every restored
    leaf must have the dtype of the matching initial leaf."""

    def __init__(self, cfg: TrainerConfig, loss_fn: Callable,
                 optimizer: Optimizer, init_params: Any,
                 batch_iter: Callable[[int], Any],
                 logger: Optional[Any] = None,
                 telemetry=None):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.batch_iter = batch_iter          # step -> batch (deterministic)
        self.logger = logger
        # observation only: a `produced` mark and event per saved checkpoint
        self.telemetry = telemetry
        self.saver = ckpt.AsyncSaver()
        self._step_fn = make_train_step(loss_fn, optimizer, cfg.grad_accum)

        self.step = 0
        self.params = init_params
        self.opt_state = optimizer.init(init_params)
        self.stopped_early = False
        self.stop_verdict: Optional[dict] = None
        self._last_saved_step: Optional[int] = None
        if cfg.ckpt_dir:
            for latest in reversed(ckpt.list_steps(cfg.ckpt_dir)):
                # virtual checkpoints (ensembles) carry no optimizer state
                if ckpt.read_extra(cfg.ckpt_dir, latest).get("virtual"):
                    continue
                self._resume(latest)
                break

    def _resume(self, step: int) -> None:
        current = {"params": self.params, "opt_state": self.opt_state}
        state, extra = ckpt.restore(self.cfg.ckpt_dir, step,
                                    template=_template(current))

        def place(saved, now):
            if saved.dtype != now.dtype:
                raise ValueError(f"checkpoint step {step}: a leaf of dtype "
                                 f"{saved.dtype} where the trainer holds "
                                 f"{now.dtype}")
            return saved.to(now.device)

        state = pytree.tree_map(place, state, current)
        self.params = state["params"]
        self.opt_state = state["opt_state"]
        self.step = int(extra.get("step", step))

    def _publish_snapshot(self, step, host_tree):
        """The async saver's host-copy hook (on its background thread): hand
        the validator the params before the durable write starts.  Only the
        params travel (the validator reads nothing else), so the optimizer
        state's pinned buffers are not held by the ring."""
        self.cfg.snapshots.publish(ParamSnapshot.from_tree(
            step, {"params": host_tree["params"]}))

    def _save(self):
        if not self.cfg.ckpt_dir:
            return
        state = {"params": self.params, "opt_state": self.opt_state}
        extra = {"step": self.step, "wall_time": time.time()}
        ch = self.cfg.snapshots
        tel = self.telemetry
        if tel is not None:
            # first edge of the checkpoint-to-verdict latency, whichever
            # hand-off route wins
            tel.mark("produced", self.step)
        if self.cfg.async_save:
            self.saver.save(
                self.cfg.ckpt_dir, self.step, state, extra,
                on_host_copy=self._publish_snapshot if ch is not None
                else None,
                on_durable=ch.mark_durable if ch is not None else None,
                on_failure=ch.mark_failed if ch is not None else None)
        else:
            ckpt.save(self.cfg.ckpt_dir, self.step, state, extra)
            if ch is not None:
                # already durable: publish after the blocking save, so the
                # sync mode keeps one code path downstream
                self._publish_snapshot(self.step, state)
                ch.mark_durable(self.step)
        self._last_saved_step = self.step
        if tel is not None:
            # async saves commit later; the COMMIT marker's mtime remains
            # the durable edge
            tel.event("produced", step=self.step,
                      async_save=self.cfg.async_save)

    def _stop_requested(self) -> bool:
        """Poll the control plane's STOP marker (async early stopping)."""
        if not self.cfg.stop_file:
            return False
        if self.step % max(self.cfg.stop_poll_every, 1) != 0:
            return False
        verdict = stop_requested(self.cfg.stop_file)
        if verdict is None:
            return False
        self.stop_verdict = verdict
        return True

    def run(self, on_metrics: Optional[Callable[[int, dict], None]] = None):
        history = []
        while self.step < self.cfg.total_steps:
            if self._stop_requested():
                self.stopped_early = True
                break
            batch = self.batch_iter(self.step)
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            # log / notify BEFORE committing the checkpoint: a consumer of
            # the metrics then knows step t before any validator can see
            # checkpoint t
            if self.step % self.cfg.log_every == 0 or \
                    self.step == self.cfg.total_steps:
                m = {k: float(v) for k, v in metrics.items()}
                history.append((self.step, m))
                if self.logger is not None:
                    self.logger.log(self.step, m)
                if on_metrics is not None:
                    on_metrics(self.step, m)
            if self.step % self.cfg.ckpt_every == 0 \
                    or self.step == self.cfg.total_steps:
                self._save()
        if self.stopped_early and self.cfg.ckpt_dir \
                and self._last_saved_step != self.step:
            self._save()    # commit the final state for selection / soups
        self.saver.wait()
        return history
