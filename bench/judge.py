"""The comparison that decides ``correct``.

Every returned list is judged in the reference's own scores:

* ``score_err``: the widest gap between a score the program returned and
  the reference's score of the same query and passage;
* ``rank_gap``: the widest gap by which the reference's score of the
  program's i-th best passage (its returned passages sorted by the
  reference's scores) lies below the reference's own i-th best, over all
  ranks; 0 when the program returned the exact top k;
* ``metric_err``: the widest gap between a metric the ledger holds and
  that metric of the program's own run, recomputed by the reference;
* ``malformed``: lists that are short, hold an unknown or repeated
  passage, or a query that is missing.

Each number has its limit in ``bench/limits/<cell>.json``; a run is
correct when every number is within its limit.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch


def list_gaps(ref_of_returned: torch.Tensor, returned: torch.Tensor,
              ref_top: torch.Tensor) -> Dict[str, float]:
    """``ref_of_returned`` (Q, k): the reference's scores of the returned
    passages; ``returned`` (Q, k): the program's scores of them;
    ``ref_top`` (Q, k): the reference's best k, descending."""
    if ref_of_returned.numel() == 0:
        return {"score_err": 0.0, "rank_gap": 0.0}
    err = (returned.double() - ref_of_returned.double()).abs().max()
    mine = torch.sort(ref_of_returned.double(), dim=1, descending=True).values
    gap = (ref_top.double() - mine).max()
    return {"score_err": float(err), "rank_gap": max(0.0, float(gap))}


def positions(ids: Sequence[str], pos_of: Dict[str, int], k: int
              ) -> List[int]:
    """Column of each returned id, or None for a malformed list."""
    if len(ids) != k or len(set(ids)) != k:
        return None
    try:
        return [pos_of[d] for d in ids]
    except KeyError:
        return None


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in readings:
        for key, v in r.items():
            out[key] = max(out.get(key, 0.0), v)
    return out


def decide(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): each limited number with its value and limit;
    a number that was not read counts as failed."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, math.inf)
        checks[name] = {"value": value if math.isfinite(value) else 1e30,
                        "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
