"""Checkpoint ensembles: top-k weight averaging and greedy metric-guided soup
(``repro/control/ensemble.py``).

Because the selector already ranks checkpoints by validation metric,
ensembling is a pure consumer:

  * ``uniform_soup``: average the weights of the given steps;
  * ``greedy_soup``: best-first, start from the top-ranked checkpoint and
    keep each next candidate only if adding it does not hurt the validation
    score, so the result scores at least the best single checkpoint under
    the same ``score_fn``.

Trees are the port's (:mod:`repro_torch.core.pytree`: nested dicts, lists
and tuples of tensors or numpy arrays).  The mean accumulates in float64
with numpy and casts back to each leaf's dtype, so for f32 and bf16 leaves
it is bit for bit the reference's ``average_params`` on the same values
(numpy rounds float64 to float32, and float64 to bfloat16 goes through
float32, as ``ml_dtypes`` does).  The port's ``ckpt.restore`` takes the
key-path ``template`` of the subtree it restores, so :func:`load_params`,
:func:`uniform_soup` and :func:`greedy_soup` take the template the
validator restores with (``AsyncValidator(template=...)``).

``materialize_virtual`` commits the soup through the ordinary two-phase
``ckpt.save`` as ``{"params", "opt_state": {}}`` with ``extra["virtual"]``,
so downstream a virtual checkpoint is validated like a trained one, and a
trainer never resumes from it.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import pytree
from repro_torch.core.suite import params_from_checkpoint

VIRTUAL_KEY = "ensemble_of"


def _float64(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()             # exact: bf16 widens losslessly
        return leaf.numpy().astype(np.float64)
    return np.asarray(leaf, np.float64)


def _cast_like(acc: np.ndarray, like) -> Any:
    """``acc`` in ``like``'s dtype and kind (a CPU tensor for a tensor)."""
    if isinstance(like, torch.Tensor):
        if like.dtype == torch.bfloat16:
            # float64 -> float32 -> bfloat16, each rounding to nearest even
            return torch.from_numpy(acc.astype(np.float32)).bfloat16()
        want = torch.empty((), dtype=like.dtype).numpy().dtype
        return torch.from_numpy(np.require(acc.astype(want),
                                           requirements="C"))
    return acc.astype(np.asarray(like).dtype)


def average_params(trees: Sequence[Any],
                   weights: Optional[Sequence[float]] = None) -> Any:
    """Leaf-wise weighted mean; accumulates in float64, restores leaf dtype."""
    if not trees:
        raise ValueError("average_params needs at least one tree")
    if weights is None:
        weights = [1.0 / len(trees)] * len(trees)
    if len(weights) != len(trees):
        raise ValueError("len(weights) != len(trees)")
    total = float(sum(weights))

    def avg(*leaves):
        acc = np.zeros(tuple(leaves[0].shape), np.float64)
        for w, leaf in zip(weights, leaves):
            acc += (w / total) * _float64(leaf)
        return _cast_like(acc, leaves[0])

    return pytree.tree_map(avg, *trees)


def load_params(root: str, step: int, template: Any,
                params_extractor: Callable = params_from_checkpoint) -> Any:
    state, _ = ckpt.restore(root, step, template=template)
    return params_extractor(state)


def uniform_soup(root: str, steps: Sequence[int], template: Any,
                 params_extractor: Callable = params_from_checkpoint) -> Any:
    return average_params([load_params(root, s, template, params_extractor)
                           for s in steps])


def greedy_soup(root: str, ranked_steps: Sequence[int],
                score_fn: Callable[[Any], float], *, template: Any,
                mode: str = "max",
                params_extractor: Callable = params_from_checkpoint,
                ) -> Tuple[Any, List[int], float]:
    """Metric-guided soup over ``ranked_steps`` (best single first).

    ``score_fn(params) -> float`` must be the scoring the selector ranked
    by for the >= best-single guarantee to mean anything.  Returns
    ``(params, member_steps, score)``."""
    if not ranked_steps:
        raise ValueError("greedy_soup needs at least one ranked step")
    better = (lambda a, b: a >= b) if mode == "max" else (lambda a, b: a <= b)
    members = [ranked_steps[0]]
    trees = [load_params(root, ranked_steps[0], template, params_extractor)]
    params = trees[0]
    score = float(score_fn(params))
    for step in ranked_steps[1:]:
        cand_trees = trees + [load_params(root, step, template,
                                          params_extractor)]
        cand = average_params(cand_trees)
        cand_score = float(score_fn(cand))
        if better(cand_score, score):
            members.append(step)
            trees = cand_trees
            params, score = cand, cand_score
    return params, members, score


def materialize_virtual(root: str, params: Any, *, members: Sequence[int],
                        step: Optional[int] = None,
                        extra: Optional[dict] = None) -> int:
    """Two-phase-commit the soup as a regular checkpoint; returns its step
    (default ``max(committed) + 1``, so the watcher discovers it as the
    newest)."""
    if step is None:
        steps = ckpt.list_steps(root)
        step = (max(steps) + 1) if steps else 0
    # "virtual" marks a checkpoint with no optimizer state: the trainer
    # skips it on resume
    meta = {"step": step, "virtual": True,
            VIRTUAL_KEY: [int(s) for s in members], **(extra or {})}
    ckpt.save(root, step, {"params": params, "opt_state": {}}, extra=meta)
    return step
