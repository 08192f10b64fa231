"""The numbers that decide ``correct``, each the gap between what the
program produced and what the reference works out from the same inputs.

- ``abs_gap``: the widest absolute gap over matching values (losses,
  probabilities).
- ``worst_leaf``: per leaf, the gap between the program's norm and the
  reference's, not the norm of their difference, over the larger of the
  reference's norm of that leaf and of the median leaf.  Leaves whose
  reference gradient is under a thousandth of the median leaf's (a key's
  bias under softmax) are left out: they move by round-off alone.
- ``row_gap``: the widest gap of a row vector, as a share of the
  reference row's norm.
- ``logodds_scatter``: how far the gaps of single answers scatter in
  log-odds: the standard deviation, over the answers, of the program's
  log-odds ``log(p / (1 - p))`` less the reference's logit margin.  A
  shift common to all answers is ``abs_gap``'s to catch; the scatter is
  steady from seed to seed where the widest gap is not.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

FLAT_SHARE = 1e-3


def abs_gap(ours: Iterable[float], ref: Iterable[float]) -> float:
    gaps = [abs(float(a) - float(b)) for a, b in zip(ours, ref)]
    if not gaps or not all(math.isfinite(g) for g in gaps):
        return math.inf
    return max(gaps)


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [n for n, v in ref_grad.items() if v >= FLAT_SHARE * med]


def leaf_gaps(ours: Dict[str, float], ref: Dict[str, float],
              ref_grad: Dict[str, float]) -> Dict[str, float]:
    """Each moving leaf's gap (see ``worst_leaf``)."""
    leaves = moving_leaves(ref_grad)
    med = statistics.median(ref[n] for n in leaves)
    return {n: abs(ours[n] - ref[n]) / max(ref[n], med) for n in leaves}


def worst_leaf(ours: Dict[str, float], ref: Dict[str, float],
               ref_grad: Dict[str, float]) -> float:
    gaps = leaf_gaps(ours, ref, ref_grad).values()
    if not all(math.isfinite(g) for g in gaps):
        return math.inf
    return max(gaps)


def row_gap(ours: torch.Tensor, ref: torch.Tensor) -> float:
    ours, ref = ours.double(), ref.double()
    gap = (torch.linalg.vector_norm(ours - ref, dim=-1)
           / torch.linalg.vector_norm(ref, dim=-1).clamp(min=1e-30)).max()
    gap = float(gap)
    return gap if math.isfinite(gap) else math.inf


def logodds_scatter(probs, ref_logits) -> float:
    p = np.clip(np.asarray(probs, np.float64), 1e-12, 1.0 - 1e-12)
    ref = np.asarray(ref_logits, np.float64)
    gap = np.log(p) - np.log1p(-p) - (ref[:, 1] - ref[:, 0])
    if not np.isfinite(gap).all():
        return math.inf
    return float(gap.std())


def verdict(readings: Dict[str, float], limits: Dict[str, float]
            ) -> List[Dict]:
    """Each number beside its limit; a number passes at or under it."""
    out = []
    for name, limit in limits.items():
        value: Optional[float] = readings.get(name)
        value = math.inf if value is None else float(value)
        out.append({"name": name, "value": value, "limit": float(limit),
                    "ok": value <= limit})
    return out
