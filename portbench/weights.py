"""Weights from the seed, made on the device in one draw.

``make`` draws one flat fp32 buffer of normal noise (deviation ``STD``,
the configurations' ``initializer_range``) with a ``torch.Generator`` on
the device and hands out views of it, one a parameter, in the layout the
model family gives (``param_shapes``); the family's norm scales
(``is_norm_scale``) get 1 added.  The same seed gives the same tensors on
the same device, so the reference works from exactly what the program was
given, made again after the program's state is freed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Tuple

import torch

STD = 0.02


def make(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
         device, is_norm_scale: Callable[[str], bool]
         ) -> Dict[str, torch.Tensor]:
    shapes = list(shapes)
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device).mul_(STD)
    out, off = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        if is_norm_scale(name):
            t.add_(1.0)
        out[name] = t
        off += n
    return out


def of(family, sizes: Dict, kind: str, seed: int, device
       ) -> Dict[str, torch.Tensor]:
    """The weights of ``seed`` for model ``kind`` of ``family`` (a
    ``families/<family>.py`` module) at ``sizes``."""
    return make(family.param_shapes(sizes, kind), seed, device,
                family.is_norm_scale)


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]
              ) -> None:
    """Copy ``weights`` into ``model``; every name and shape must match."""
    mine = dict(model.named_parameters())
    if set(mine) != set(weights):
        raise KeyError(f"weights and model differ: only in the model "
                       f"{sorted(set(mine) - set(weights))[:5]}, only in the "
                       f"weights {sorted(set(weights) - set(mine))[:5]}")
    with torch.no_grad():
        for name, p in mine.items():
            p.copy_(weights[name])
