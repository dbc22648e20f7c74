"""Validation-fidelity analysis (paper Figure 2 left, quantified;
``repro/core/fidelity.py``).

The paper's observation: subset validation overestimates MRR@10 but
preserves the *trend* across checkpoints; subsets induced by stronger
baselines track the full-corpus curve better.  These statistics quantify
that: rank correlation of checkpoint orderings, best-checkpoint agreement,
and the overestimation bias.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence


def pearson(a: Sequence[float], b: Sequence[float]) -> float:
    n = len(a)
    ma, mb = sum(a) / n, sum(b) / n
    cov = sum((x - ma) * (y - mb) for x, y in zip(a, b))
    va = math.sqrt(sum((x - ma) ** 2 for x in a))
    vb = math.sqrt(sum((y - mb) ** 2 for y in b))
    return cov / (va * vb) if va * vb > 0 else 0.0


def _ranks(xs: Sequence[float]) -> List[float]:
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    ranks = [0.0] * len(xs)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and xs[order[j + 1]] == xs[order[i]]:
            j += 1
        avg = (i + j) / 2 + 1
        for k in range(i, j + 1):
            ranks[order[k]] = avg
        i = j + 1
    return ranks


def spearman(a: Sequence[float], b: Sequence[float]) -> float:
    return pearson(_ranks(a), _ranks(b))


def kendall_tau(a: Sequence[float], b: Sequence[float]) -> float:
    n = len(a)
    conc = disc = 0
    for i in range(n):
        for j in range(i + 1, n):
            s = (a[i] - a[j]) * (b[i] - b[j])
            if s > 0:
                conc += 1
            elif s < 0:
                disc += 1
    total = n * (n - 1) / 2
    return (conc - disc) / total if total else 0.0


def best_checkpoint_agreement(reference: Sequence[float],
                              estimate: Sequence[float],
                              higher_is_better: bool = True) -> bool:
    """Does the subset pick the same argbest checkpoint as the full corpus?"""
    pick = max if higher_is_better else min
    ref_best = pick(range(len(reference)), key=lambda i: reference[i])
    est_best = pick(range(len(estimate)), key=lambda i: estimate[i])
    return ref_best == est_best


def overestimation(reference: Sequence[float],
                   estimate: Sequence[float]) -> Dict[str, float]:
    deltas = [e - r for r, e in zip(reference, estimate)]
    return {"mean_delta": sum(deltas) / len(deltas),
            "max_delta": max(deltas), "min_delta": min(deltas),
            "always_overestimates": float(all(d >= 0 for d in deltas))}


def fidelity_report(reference: Sequence[float], estimate: Sequence[float],
                    higher_is_better: bool = True) -> Dict[str, float]:
    return {
        "pearson": pearson(reference, estimate),
        "spearman": spearman(reference, estimate),
        "kendall_tau": kendall_tau(reference, estimate),
        "best_ckpt_agreement": float(best_checkpoint_agreement(
            reference, estimate, higher_is_better)),
        **overestimation(reference, estimate),
    }
