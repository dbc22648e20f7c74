"""Optimizers and schedules (``repro/train/optim.py``) on PyTorch tensors.

The reference's optax-style interface, kept functional:
``opt.init(params) -> state`` and ``opt.update(grads, state, params) ->
(new_params, new_state)`` over the port's parameter trees (nested dicts of
tensors, :mod:`repro_torch.core.pytree`).  ``update`` never writes into
its inputs: every step returns new tensors, so a checkpoint copy still in
flight from the previous step's tensors (:class:`repro_torch.ckpt.
checkpoint.AsyncSaver`) cannot be raced by the update.  Moments and the
arithmetic are f32; the step counter is a 0-d int32 tensor on the params'
device, so nothing here waits on the card.

  * AdamW (f32 moments), weight decay on matrices only (``_is_matrix``);
  * Adafactor (factored second moments);
  * global-norm clipping;
  * error-feedback int8 gradient compression (``compressed``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import pytree


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params) -> (params, state)
    update: Callable[[Any, Any, Any], Any]


# ---------------------------------------------------------------------------
# Schedules: step (a tensor or a number) -> learning rate (0-d f32 tensor)
# ---------------------------------------------------------------------------


def _as_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def sched(step):
        step = _as_f32(step)
        warm = peak_lr * step / max(1.0, warmup_steps)
        prog = torch.clamp((step - warmup_steps)
                           / max(1.0, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


def constant(lr: float):
    return lambda step: torch.full_like(_as_f32(step), lr)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def global_norm(tree) -> torch.Tensor:
    leaves = pytree.tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in leaves))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return pytree.tree_map(lambda g: g * scale.to(g.dtype), tree), norm


def _is_matrix(x) -> bool:
    return x.ndim >= 2


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    leaves = pytree.tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(lr: Callable | float, *, b1=0.9, b2=0.999, eps=1e-8,
          weight_decay=0.01, max_grad_norm: Optional[float] = 1.0,
          decay_mask: Optional[Callable[[Any], Any]] = None) -> Optimizer:
    sched = lr if callable(lr) else constant(lr)

    def init(params):
        return {"step": _step0(params),
                "m": pytree.tree_map(_zeros_f32, params),
                "v": pytree.tree_map(_zeros_f32, params)}

    @torch.no_grad()
    def update(grads, state, params):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state["step"] + 1
        step_f = step.to(torch.float32)
        lr_t = sched(step)
        b1c = 1 - torch.pow(b1, step_f)
        b2c = 1 - torch.pow(b2, step_f)
        mask = (decay_mask(params) if decay_mask is not None
                else pytree.tree_map(_is_matrix, params))

        def upd(p, g, m, v, use_wd):
            g32 = g.float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * torch.square(g32)
            mhat, vhat = m / b1c, v / b2c
            delta = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                delta = delta + (weight_decay if use_wd else 0.0) * p.float()
            return (p.float() - lr_t * delta).to(p.dtype), m, v

        flat_p, tdef = pytree.tree_flatten(params)
        flat_g = tdef.flatten_up_to(grads)
        flat_m = tdef.flatten_up_to(state["m"])
        flat_v = tdef.flatten_up_to(state["v"])
        flat_mask = tdef.flatten_up_to(mask)
        out = [upd(p, g, m, v, w) for p, g, m, v, w in
               zip(flat_p, flat_g, flat_m, flat_v, flat_mask)]
        new_p = tdef.unflatten([o[0] for o in out])
        new_m = tdef.unflatten([o[1] for o in out])
        new_v = tdef.unflatten([o[2] for o in out])
        return new_p, {"step": step, "m": new_m, "v": new_v}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; no first moment)
# ---------------------------------------------------------------------------


def adafactor(lr: Callable | float, *, decay=0.8, eps=1e-30,
              clip_threshold=1.0, weight_decay=0.0,
              max_grad_norm: Optional[float] = 1.0) -> Optimizer:
    sched = lr if callable(lr) else constant(lr)

    def init(params):
        def slot(p):
            if p.ndim >= 2:
                return {"vr": _zeros_f32(p[..., 0]),
                        "vc": _zeros_f32(p[..., 0, :])}
            return {"v": _zeros_f32(p)}
        return {"step": _step0(params),
                "slots": pytree.tree_map(slot, params)}

    @torch.no_grad()
    def update(grads, state, params):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state["step"] + 1
        lr_t = sched(step)
        beta = 1.0 - torch.pow(step.to(torch.float32), -decay)

        def upd(p, g, slot):
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if p.ndim >= 2:
                vr = beta * slot["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * slot["vc"] + (1 - beta) * g2.mean(-2)
                rfac = torch.rsqrt(
                    vr / torch.clamp(vr.mean(-1, keepdim=True), min=eps)
                )[..., :, None]
                cfac = torch.rsqrt(vc)[..., None, :]
                u = g32 * rfac * cfac
                new_slot = {"vr": vr, "vc": vc}
            else:
                v = beta * slot["v"] + (1 - beta) * g2
                u = g32 * torch.rsqrt(v)
                new_slot = {"v": v}
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            delta = lr_t * u
            if weight_decay:
                delta = delta + lr_t * weight_decay * p.float()
            return (p.float() - delta).to(p.dtype), new_slot

        flat_p, tdef = pytree.tree_flatten(params)
        flat_g = tdef.flatten_up_to(grads)
        flat_s = tdef.flatten_up_to(state["slots"])
        out = [upd(p, g, s) for p, g, s in zip(flat_p, flat_g, flat_s)]
        return (tdef.unflatten([o[0] for o in out]),
                {"step": step, "slots": tdef.unflatten([o[1] for o in out])})

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Error-feedback int8 gradient compression
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor):
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed(inner: Optimizer) -> Optimizer:
    """Error-feedback int8 gradient compression around ``inner``: each
    gradient (plus the error carried from the last step) is quantized to
    int8 with one scale per tensor and dequantized, and what the round trip
    lost is carried into the next step (EF-SGD).  The quantized tensors are
    what a gradient all-reduce would send; here the round trip models the
    numerics."""

    def init(params):
        return {"inner": inner.init(params),
                "err": pytree.tree_map(_zeros_f32, params)}

    @torch.no_grad()
    def update(grads, state, params):
        def comp(g, e):
            corrected = g.float() + e
            q, scale = quantize_int8(corrected)
            deq = dequantize_int8(q, scale)
            return deq, corrected - deq

        flat_g, tdef = pytree.tree_flatten(grads)
        flat_e = tdef.flatten_up_to(state["err"])
        pairs = [comp(g, e) for g, e in zip(flat_g, flat_e)]
        deq = tdef.unflatten([p[0] for p in pairs])
        err = tdef.unflatten([p[1] for p in pairs])
        new_params, inner_state = inner.update(deq, state["inner"], params)
        return new_params, {"inner": inner_state, "err": err}

    return Optimizer(init, update)
