"""Model soup: the element-wise average of parameter sets.

Port of ``item_alignment_tpu/aggregate/soup.py`` on torch state dicts (the
reference sums the epoch checkpoints' tensors and divides,
``model_soup_text.py:226-251``).  The sum runs in the JAX package's order,
``((a + b) + c) / n``, on whatever device the tensors lie on.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from item_alignment_torch.device import resolve_device
from item_alignment_torch.engine.checkpoint import load_params

State = Dict[str, torch.Tensor]


def load_state_dicts(paths: Sequence[str], device=None) -> List[State]:
    """``.pt`` or Flax ``.msgpack`` state dicts onto ``device`` (None means
    ``"cuda"``)."""
    dev = resolve_device(device)
    return [{k: v.to(dev) for k, v in load_params(p).items()} for p in paths]


def uniform_soup(states: Sequence[State],
                 include: Optional[Callable[[str], bool]] = None) -> State:
    """The average of state dicts with the same keys and shapes.

    ``include(name) -> bool`` restricts the average to some entries (the
    reference averages parameters and passes buffers through); the others
    come from the LAST state dict."""
    if not states:
        raise ValueError("a soup needs at least one state dict")
    if len(states) == 1:
        return states[0]
    n = float(len(states))
    out = {}
    for name in states[0]:
        leaves = [s[name] for s in states]
        if include is None or include(name):
            out[name] = sum(leaves[1:], leaves[0]) / n
        else:
            out[name] = leaves[-1]
    return out


def greedy_soup(states: Sequence[State],
                score_fn: Callable[[State], float]) -> State:
    """Greedy soup (Wortsman et al.): take the state dicts best first and
    keep each one only if the running average's ``score_fn`` does not
    drop."""
    scored = sorted(states, key=score_fn, reverse=True)
    soup = [scored[0]]
    best = score_fn(scored[0])
    for state in scored[1:]:
        s = score_fn(uniform_soup(soup + [state]))
        if s >= best:
            soup.append(state)
            best = s
    return uniform_soup(soup)
